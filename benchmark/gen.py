"""The one traffic generator: it reads a traffic mix's parameters (a file
``traffic/<mix>.json``) and makes the cell's inputs from ``--seed`` on the
device, in set-up. The ego actions come from the module that the mix's
``actions.kind`` names (``benchmark/actions/<kind>.py``, found by name).

Fresh weights are made here too, on the device from the seed, in one
draw: LeCun-normal matrices and kernels (variance 1 / fan-in), zero
biases; and a replay ring's history, as a run resumed past its start
holds it (``fill_ring``).
"""

from __future__ import annotations

import importlib
import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

# the env's generator, the actions' and the weights' are seeded apart from
# one --seed
ENV_STREAM, ACTION_STREAM, WEIGHT_STREAM, REPLAY_STREAM = 0, 1, 2, 3
# a filled ring's episodes end with this chance a cell, half of them
# terminated and half truncated
EPISODE_END = 0.01
FILL_ENVS = 16          # envs a frame draw (its temporary stays small)


def stream_seed(seed: int, stream: int) -> int:
    """A generator seed of its own for each stream of one ``--seed``."""
    return (int(seed) * 2 + stream) % (2 ** 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  stream))


def action_kind(kind: str):
    """``benchmark/actions/<kind>.py``."""
    return importlib.import_module(f"benchmark.actions.{kind}")


def action_source(spec: dict, *, num_envs: int, seed: int, device,
                  cfg=None, assets=None) -> Optional[Callable]:
    """The mix's ego actions: ``None`` (the learner's own) or
    ``actions(state, k) -> (num_envs, 2)`` float32 for step ``k``."""
    return action_kind(spec["kind"]).make(
        spec, num_envs=num_envs, seed=seed, device=device, cfg=cfg,
        assets=assets)


def fresh_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                  device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for the named shapes: biases (1-d) zero, the
    rest N(0, 1 / fan_in), all drawn in one call."""
    shapes = list(shapes)
    total = sum(math.prod(s) for _, s in shapes if len(s) > 1)
    z = torch.randn(total, generator=generator(seed, WEIGHT_STREAM, device),
                    device=device)
    out, at = {}, 0
    for name, shape in shapes:
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        fan_in = n // shape[0]
        out[name] = z[at:at + n].reshape(shape) / math.sqrt(fan_in)
        at += n
    return out


def npz_weights(path: str, device) -> Dict[str, torch.Tensor]:
    """The float arrays of an exported ``.npz`` as tensors on ``device``
    (its integer metadata left out)."""
    with np.load(path) as z:
        return {k: torch.from_numpy(z[k]).to(device) for k in z.files
                if z[k].dtype.kind == "f"}


def fill_ring(buf, cells: int, seed: int, device, demo: bool = True):
    """Fill the first ``cells`` cells of every env of an empty replay ring
    (the layout of ``rl/buffer.py``, by its fields) in place, from the seed:
    uint8 frames, actions in (-1, 1), N(0, 1) rewards, episodes that end
    with chance ``EPISODE_END`` a cell and at the last filled cell (so that
    the envs' running episodes start at the next), their starts, the
    side ring's slots and frames, and ``is_demo`` = ``demo`` (the history
    of a run past its demonstration phase was all scripted). The same
    seed gives the same ring to any buffer of the same shape."""
    g = generator(seed, REPLAY_STREAM, device)
    e, n, c, h, w = buf.frames.shape
    k = buf.term_frames.shape[1]
    f = min(int(cells), n)
    u8 = dict(dtype=torch.uint8, generator=g, device=device)
    for lo in range(0, e, FILL_ENVS):
        hi = min(lo + FILL_ENVS, e)
        buf.frames[lo:hi, :f] = torch.randint(0, 256, (hi - lo, f, c, h, w),
                                              **u8)
        buf.term_frames[lo:hi] = torch.randint(0, 256, (hi - lo, k, c, h, w),
                                               **u8)
    draws = torch.rand((2, e, f), generator=g, device=device)
    buf.action[:, :f] = (torch.rand((e, f, buf.action.shape[2]),
                                    generator=g, device=device) * 2.0 - 1.0)
    buf.reward[:, :f] = torch.randn((e, f), generator=g, device=device)
    done = draws[0] < EPISODE_END
    done[:, f - 1] = True
    terminal = done & (draws[1] < 0.5)
    terminal[:, f - 1] = True
    buf.done[:, :f] = done
    buf.terminal[:, :f] = terminal
    # a cell's episode starts after the last done cell before it
    after = torch.where(done, torch.arange(1, f + 1, device=device), 0)
    start = torch.cat([torch.zeros((e, 1), dtype=after.dtype,
                                   device=device), after[:, :-1]], dim=1)
    buf.ep_start[:, :f] = torch.remainder(start.cummax(dim=1).values,
                                          n).to(torch.int32)
    trunc = (done & ~terminal).to(torch.int32)
    before = torch.cumsum(trunc, dim=1) - trunc
    buf.term_slot[:, :f] = torch.remainder(before, k).to(torch.int32)
    buf.term_ptr.copy_(trunc.sum(dim=1).to(torch.int32))
    buf.is_demo[:, :f] = demo
    buf.pos.fill_(f)
    buf.filled.fill_(f)
    buf.cur_ep_start.fill_(f % n)
    return buf
