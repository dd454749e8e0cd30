"""The yardstick's reading of the program's own spans and counters
(``torchdriveenv_tpu_torch/utils/spans.py``): the log that the traced
window left in the process, read in place after the run. Under
``--trace 1`` the traced window is the only code that runs under the
profiler, so the log holds its spans alone.

Of each span only its name, its parent and its two ends on the device's
stream (its CUDA events) are read; durations, self times and the per-step
normalisation are computed here. A span's stream time is its share of the
device's timeline, idle included, so sibling spans add up to their
parent's. Where the program has no span module, its log has no span of the
name, or a span has no stream times (no card), the reading is ``None``."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple


def log() -> Optional[Tuple[List[dict], Dict[str, float]]]:
    """(records, counters) of the program's span log, or None where the
    program has no span module."""
    try:
        from torchdriveenv_tpu_torch.utils import spans
    except ImportError:
        return None
    return spans.records(), spans.counters()


def union_ms(intervals, lo: float, hi: float) -> float:
    """The length of the union of ``intervals`` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total, end = total + b - a, b
    return total


def _stream(rec: dict):
    a, b = rec.get("stream_start_ms"), rec.get("stream_end_ms")
    return None if a is None or b is None else (a, b)


def stream_ms(recs: List[dict], name: str,
              self_time: bool = False) -> Optional[List[float]]:
    """The stream ms of every span ``name`` (``self_time``: less the union
    of its children's), None where there is none or one lacks its ends."""
    picked = [i for i, r in enumerate(recs) if r["name"] == name]
    if not picked:
        return None
    kids: Dict[int, list] = {}
    for r in recs:
        iv = _stream(r)
        if iv is not None:
            kids.setdefault(r["parent"], []).append(iv)
    out = []
    for i in picked:
        iv = _stream(recs[i])
        if iv is None:
            return None
        out.append(iv[1] - iv[0]
                   - (union_ms(kids.get(i, ()), *iv) if self_time else 0.0))
    return out


def per_step(name: str, step: str, self_time: bool = False
             ) -> Optional[float]:
    """The stream ms of the spans ``name`` in all over the number of spans
    ``step``."""
    got = log()
    if got is None:
        return None
    recs = got[0]
    ms = stream_ms(recs, name, self_time)
    steps = sum(r["name"] == step for r in recs)
    return None if ms is None or not steps else sum(ms) / steps


def mean(name: str) -> Optional[float]:
    """The mean stream ms of the spans ``name``."""
    got = log()
    ms = None if got is None else stream_ms(got[0], name)
    return None if ms is None else sum(ms) / len(ms)


def count_per_step(counter: str, step: str) -> Optional[float]:
    """The counter's total over the number of spans ``step``."""
    got = log()
    if got is None:
        return None
    recs, counters = got
    steps = sum(r["name"] == step for r in recs)
    if counter not in counters or not steps:
        return None
    return counters[counter] / steps
