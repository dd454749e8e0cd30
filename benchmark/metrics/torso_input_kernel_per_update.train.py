"""Runs of the torso input kernel (``csrc/torso_input.cu``) per SAC update:
the trace's ``torso_input_kernel`` events over the traced train steps'
updates. An update makes its stacks' and its next stacks' input once each
(2), and each env step's action makes one, so the stage-1 recipe's 64
updates and 4 env steps a train step read 2 + 4 / 64 = 2.0625; nothing
where the kernel is not on the path."""

from benchmark.metrics import _torso_input

MOVES = "train_step_device_ms"


def read(r):
    return _torso_input.per_update(r, _torso_input.sac_updates(r))
