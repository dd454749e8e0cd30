"""The yardstick's count of the data-parallel PPO train step's least work
and the link's peak, frozen: an update's gradient steps and the rollout's
forwards from the networks' shapes (``_learner``'s ``torso_flops`` /
``dense_flops``), never from what an implementation runs; and the reading
of a trace's collectives.

NVIDIA H100 SXM data sheet: fourth-generation NVLink, 900 GB/s a card in
both directions together, 450 GB/s each way.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from benchmark.metrics import _learner

NVLINK_PEAK_BYTES = 450e9       # one direction, a card
HEADS = ("mu", "value")         # the f32 heads over the torso's features

Shapes = Dict[str, Tuple[int, ...]]


def forward_flops(shapes: Shapes, obs_res: int) -> Tuple[int, int, int]:
    """-> (bf16 torso flops, f32 head flops, the first convolution's flops)
    of one sample's forward through the actor-critic."""
    torso, first = _learner.torso_flops(shapes, "torso.", obs_res)
    return torso, _learner.dense_flops(shapes, HEADS), first


def gradient_step_cost(shapes: Shapes, batch: int,
                       obs_shape: Tuple[int, int, int]) -> dict:
    """{"bf16_flops", "f32_flops", "bytes"} of one gradient step on
    ``batch`` rows: the forward, and a backward of each layer's weight and
    input gradient (two forwards' worth) but the first convolution's input
    gradient; bytes: the rows' uint8 stacks read, the parameters,
    gradients and Adam's two moments read and written once."""
    torso, heads, first = forward_flops(shapes, obs_shape[1])
    n_params = sum(math.prod(s) for s in shapes.values())
    return {"bf16_flops": batch * (3 * torso - first),
            "f32_flops": batch * 3 * heads,
            "bytes": batch * math.prod(obs_shape)
            + 4 * n_params * (2 + 2 + 4 + 2)}


def rollout_forward_cost(shapes: Shapes, rows: int, obs_res: int) -> dict:
    """{"bf16_flops", "f32_flops"} of forwards over ``rows`` stacks."""
    torso, heads, _ = forward_flops(shapes, obs_res)
    return {"bf16_flops": rows * torso, "f32_flops": rows * heads}


def nccl_kernels(trace: dict) -> List[dict]:
    """The trace's nccl kernels (their names start ``nccl``)."""
    return [k for k in trace.get("kernels", ())
            if k.get("name", "").lower().startswith("nccl")]
