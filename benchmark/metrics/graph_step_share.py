"""The share of the traced env steps that replayed the step's CUDA graphs:
the program's ``env.graph_replays`` counter (a chain already captured, run
again) over the number of ``env.step`` spans in the traced window. A
program that counts neither replays, captures (``env.graph_captures``)
nor eager steps (``env.eager_steps``) reads nothing."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"
COUNTERS = {"env.graph_replays", "env.graph_captures", "env.eager_steps"}


def read(r):
    got = _spans.log()
    if got is None:
        return None
    recs, counters = got
    steps = sum(rec["name"] == "env.step" for rec in recs)
    if not steps or not COUNTERS & set(counters):
        return None
    return counters.get("env.graph_replays", 0) / steps
