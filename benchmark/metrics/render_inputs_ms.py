"""The render inputs' time an env step: the stream ms of the program's
``env.render_inputs`` spans (``ops/rasterizer_cuda.py:prepare_obs_inputs``,
the culls and packing in torch before the kernel) over the number of
``env.step`` spans in the traced window."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.per_step("env.render_inputs", "env.step")
