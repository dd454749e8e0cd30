"""The physics and reward's time an env step: the self stream ms of the
program's ``env.core`` spans (``core.step``: kinematics, collision,
offroad, lights, waypoints, reward; the ``env.npc`` span inside it left
out) over the number of ``env.step`` spans in the traced window."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    return _spans.per_step("env.core", "env.step", self_time=True)
