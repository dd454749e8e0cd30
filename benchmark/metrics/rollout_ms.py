"""The rollout's part of a train step: the stream ms of the program's
``train.env`` spans (the on-policy step's env steps with the policy's
actions, the terminal values and the last value) over the number of
``train.step`` spans in rank 0's traced train step."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.per_step("train.env", "train.step")
