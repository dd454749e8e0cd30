"""``uniform``: every env's ego action drawn uniformly over the box
[``low``, ``high``] afresh for every step, made on the device in set-up as
a ring of ``ring_steps`` steps; step ``k`` takes ring row
``k mod ring_steps``."""

from __future__ import annotations

import torch

from benchmark import gen


def make(spec: dict, *, num_envs: int, seed: int, device, cfg=None,
         assets=None):
    g = gen.generator(seed, gen.ACTION_STREAM, device)
    low = torch.tensor(spec["low"], dtype=torch.float32, device=device)
    high = torch.tensor(spec["high"], dtype=torch.float32, device=device)
    u = torch.rand((spec["ring_steps"], num_envs, 2), generator=g,
                   device=device)
    ring = low + u * (high - low)
    n = ring.shape[0]
    return lambda state, k: ring[k % n]
