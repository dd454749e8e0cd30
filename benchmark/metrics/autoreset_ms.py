"""The auto-reset's time an env step: the stream ms of the program's
``env.autoreset`` spans (``env/batched.py:_autoreset``: the pool's draws
and its consumption) over the number of ``env.step`` spans in the traced
window."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.per_step("env.autoreset", "env.step")
