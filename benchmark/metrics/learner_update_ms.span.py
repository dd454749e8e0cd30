"""One learner update's time in place: the mean stream ms of the
program's ``train.update`` spans (the call site of the agent's ``update``)
in the traced train step; the twin of ``learner_update_ms``, which the
harness times with its own events around every update of the window."""

from benchmark.metrics import _spans

MOVES = "train_step_device_ms"


def read(r):
    return _spans.mean("train.update")
