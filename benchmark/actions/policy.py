"""``policy``: the learner's own actions (a training cell). Nothing is
drawn here."""

from __future__ import annotations


def make(spec: dict, *, num_envs: int, seed: int, device, cfg=None,
         assets=None):
    return None
