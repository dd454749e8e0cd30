"""Runs of the NPC controller's kernel per env step: the trace's kernel
events named ``npc_gaps_kernel`` (``csrc/npc_gaps.cu``) over the traced
env steps. 1 where each step's nearest obstacles and stoplines go through
the kernel (a trace loses a kernel record now and then, so it can read a
little under); nothing where no such kernel ran."""

MOVES = "env_steps_per_s"
KERNEL = "npc_gaps_kernel"


def read(r):
    t = r.get("trace")
    if not t or not r.get("trace_steps"):
        return None
    runs = sum(1 for e in t["kernels"] if KERNEL in e["name"])
    if not runs:
        return None
    return runs / r["trace_steps"]
