"""The sharded update's wait for its owned rows: the host time of the
program's ``ppo.owned_rows`` spans (``rl/ppo.py:_owned_rows``, whose
``nonzero`` waits for the device to reach it) over the number of
``train.step`` spans in rank 0's traced train step."""

from benchmark.metrics import _spans

MOVES = "env_steps_per_s"


def read(r):
    log = _spans.log()
    if not log:
        return None
    recs = log[0]
    steps = sum(x["name"] == "train.step" for x in recs)
    waits = [x["host_ms"] for x in recs if x["name"] == "ppo.owned_rows"]
    if not steps or not waits or None in waits:
        return None
    return sum(waits) / steps
