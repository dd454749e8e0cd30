"""One replay sample's time: the mean stream ms of the program's
``train.sample`` spans (``rl/buffer.py:sample`` at the call site) in the
traced train step."""

from benchmark.metrics import _spans

MOVES = "train_step_device_ms"


def read(r):
    return _spans.mean("train.sample")
