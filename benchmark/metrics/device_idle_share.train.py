"""The share of a train step in which no operation runs on the device:
100 x (1 - the device's busy time in the traced train step (the union of
its operations' intervals) over the window's time per train step). As for
the env cells, the busy time comes from the trace and the step's time from
the untraced window, which the profiler does not slow."""

MOVES = "train_step_device_ms"


def read(r):
    t = r.get("trace")
    if not t or not r.get("trace_steps") or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / r["trace_steps"] / r["per_step_s"])
