"""The yardstick's count of a learner update's least work, from the
networks' shapes (never from what an implementation runs): the NatureCNN
torso (three convolutions and a dense layer, run in bfloat16) and the f32
heads, forward and backward, and the bytes an update must move."""

from __future__ import annotations

import math
from typing import Dict, Tuple

VALID_MIN_RES = 36

Shapes = Dict[str, Tuple[int, ...]]


def _conv_out(n: int, kernel: int, stride: int, valid: bool) -> int:
    """A side after one convolution: no padding ("VALID") for inputs of
    ``VALID_MIN_RES`` pixels and more, XLA's "SAME" below that."""
    if valid:
        return (n - kernel) // stride + 1
    return -(-n // stride)


def torso_flops(shapes: Shapes, prefix: str, obs_res: int):
    """-> (forward flops of one sample through the torso under ``prefix``,
    those of its first convolution). A multiply-add counts two."""
    n, total, first = obs_res, 0, 0
    for i, stride in ((1, 4), (2, 2), (3, 1)):
        o, c, k, _ = shapes[f"{prefix}conv{i}.weight"]
        n = _conv_out(n, k, stride, obs_res >= VALID_MIN_RES)
        f = 2 * n * n * o * c * k * k
        total += f
        first = first or f
    o, c = shapes[f"{prefix}fc.weight"]
    return total + 2 * o * c, first


def dense_flops(shapes: Shapes, names) -> int:
    return sum(2 * math.prod(shapes[f"{n}.weight"]) for n in names)


def sac_update_cost(actor: Shapes, critic: Shapes, batch: int,
                    obs_shape: Tuple[int, int, int]) -> dict:
    """{"bf16_flops", "f32_flops", "bytes"} of one SAC update on ``batch``
    samples. Forward: the actor and the target critic on the next stacks,
    the critic on the stacks (its torso features serve the actor's loss
    too), the actor on the stacks, the critic's heads on the actor's
    actions. Backward: the critic loss through the whole critic, the actor
    loss through the critic's heads and the whole actor, each layer's
    weight and input gradient (two forwards' worth) except the first
    convolution's input gradient. Bytes: the two stacks of every sample
    read, the critic's parameters, gradients and Adam moments read and
    written once, the target critic read and written once."""
    t, t1 = torso_flops(actor, "torso.", obs_shape[1])
    tq, tq1 = torso_flops(critic, "q1_torso.", obs_shape[1])
    ha = dense_flops(actor, ("latent", "mu", "log_std"))
    hq = dense_flops(critic, ("q1_h", "q1_out"))
    bf16 = (2 * t + 2 * (2 * tq)                 # actor x2, critic and target
            + 2 * (2 * tq) - 2 * tq1             # critic backward
            + 2 * t - t1)                        # actor backward
    f32 = (2 * ha + 3 * (2 * hq)                 # forwards of the heads
           + 2 * (2 * hq) + 2 * ha + 2 * (2 * hq))   # backwards
    n_critic = sum(math.prod(s) for s in critic.values())
    stacks = 2 * math.prod(obs_shape)            # uint8 obs and next obs
    nbytes = batch * stacks + 4 * n_critic * (2 + 2 + 4 + 2)
    return {"bf16_flops": batch * bf16, "f32_flops": batch * f32,
            "bytes": nbytes}
