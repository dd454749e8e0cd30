"""Collectives a train step issues: the program's counter
``mesh.collectives`` (one an ``all_reduce`` or ``broadcast`` of
``parallel/mesh.py``) over the number of ``train.step`` spans in rank 0's
traced train step."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.count_per_step("mesh.collectives", "train.step")
