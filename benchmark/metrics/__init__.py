"""Per-layer metrics, one reader a file (``<metric>.py``: ``MOVES`` and
``read(readings)``), and the yardstick's arithmetic they share
(``_costs.py``, ``_trace.py``). A reader that finds nothing to read
returns ``None`` and the metric is left out of the line."""
