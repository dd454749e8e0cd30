"""The share of an env step in which no operation runs on the device:
100 x (1 - the device's busy time per traced step (the union of its
operations' intervals in the trace, over the traced steps) over the
window's time per step (all its time over all its steps)).

The device's busy time is taken from the trace and the step's time from
the untraced window: under the profiler the host launches about three
times slower, so the traced window's own idle share (``device.busy_s``
against ``device.window_s`` in the line) reads far higher than the
window's."""

MOVES = "env_steps_per_s"


def read(r):
    t = r.get("trace")
    if not t or not r.get("trace_steps") or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / r["trace_steps"] / r["per_step_s"])
