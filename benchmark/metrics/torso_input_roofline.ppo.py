"""The torso input kernel's share of its roofline on rank 0's card in the
data-parallel PPO cell: the least time of the traced train step's passes
(``_torso_input``: each pass's rows from its launch, 3 bytes a value of the
stack at the HBM rate) over the kernel's device time in the trace; nothing
where the kernel is not on the path."""

from benchmark.metrics import _torso_input

MOVES = "env_steps_per_s"


def read(r):
    return _torso_input.roofline(r)
