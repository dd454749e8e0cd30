"""Runs of the torso input kernel (``csrc/torso_input.cu``) per PPO
gradient step on rank 0's card: the trace's ``torso_input_kernel`` events
over the traced train step's gradient steps. A gradient step makes its
minibatch rows' input once (1); the rollout's forwards of the card's envs
add theirs (2 an env step, and the last value's), ~1.25 at 32 env steps and
256 gradient steps; nothing where the kernel is not on the path."""

from benchmark.metrics import _torso_input

MOVES = "env_steps_per_s"


def read(r):
    return _torso_input.per_update(r, _torso_input.ppo_gradient_steps(r))
