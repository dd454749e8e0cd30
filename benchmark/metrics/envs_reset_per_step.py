"""The pooled reset's load: the program's ``envs_reset`` counter (the
done mask ``_autoreset`` holds, summed) over the number of ``env.step``
spans in the traced window."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.count_per_step("envs_reset", "env.step")
