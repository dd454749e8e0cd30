"""The render's time an env step: the stream ms of the program's
``env.render`` spans (every birdview of the step: the render inputs and
the rasterizer kernel) over the number of ``env.step`` spans in the traced
window."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.per_step("env.render", "env.step")
