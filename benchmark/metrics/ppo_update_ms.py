"""The PPO update's part of a train step: the stream ms of the program's
``train.update`` spans (the call of the agent's ``update``: GAE and the
epochs' gradient steps with their collectives) over the number of
``train.step`` spans in rank 0's traced train step."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.per_step("train.update", "train.step")
