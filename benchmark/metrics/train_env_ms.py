"""The env part of a train step: the stream ms of the program's
``train.env`` spans (the ``steps_per_iter`` env steps with their actions
and ring appends) over the number of ``train.step`` spans in the traced
train step."""

from benchmark.metrics import _spans

MOVES = "train_step_device_ms"


def read(r):
    return _spans.per_step("train.env", "train.step")
