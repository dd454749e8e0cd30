"""The device time of the collectives in a train step: the summed
durations of the nccl kernels in rank 0's traced train step over the
train steps traced. Under nccl a rank's all-reduce kernel spins from its
launch until the slowest peer has launched its own, so this is wait as
much as transfer."""

from benchmark.metrics import _ppo_costs

MOVES = "env_steps_per_s"


def read(r):
    t = r.get("trace")
    if not t or not r.get("trace_steps"):
        return None
    kernels = _ppo_costs.nccl_kernels(t)
    if not kernels:
        return None
    return sum(k["dur"] for k in kernels) * 1e-3 / r["trace_steps"]
