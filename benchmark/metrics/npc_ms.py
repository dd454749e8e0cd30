"""The NPC controller's time an env step: the stream ms of the program's
``env.npc`` spans (``env/core.py:step`` around the IDM route follower or the
GRU policy) over the number of ``env.step`` spans in the traced window."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.per_step("env.npc", "env.step")
