"""Kernel launches per env step: the kernel events in the trace of the
traced env steps over their number (the host's launches are what bounds
the step, ~1000 of them)."""

MOVES = "env_steps_per_s"


def read(r):
    t = r.get("trace")
    if not t or not r.get("trace_steps"):
        return None
    return len(t["kernels"]) / r["trace_steps"]
