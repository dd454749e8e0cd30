"""The share of a data-parallel train step in which rank 0's card runs
nothing: 100 x (1 - its busy time in the traced train step (the union of
its operations' intervals, nccl's kernels included) over the window's time
per train step)."""

MOVES = "env_steps_per_s"


def read(r):
    t = r.get("trace")
    if not t or not r.get("trace_steps") or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / r["trace_steps"] / r["per_step_s"])
