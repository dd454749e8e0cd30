"""Policy / value networks (port of ``torchdriveenv_tpu/models``) and the
loader of the trained SAC actor that ships with the package."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from torchdriveenv_tpu_torch.maps.arrays import resolve_device
from torchdriveenv_tpu_torch.models.cnn import NatureCNN
from torchdriveenv_tpu_torch.models.policies import (
    DeterministicActor,
    DoubleQCritic,
    GaussianActorCritic,
    SquashedGaussianActor,
)

__all__ = [
    "NatureCNN",
    "SquashedGaussianActor",
    "DeterministicActor",
    "DoubleQCritic",
    "GaussianActorCritic",
    "DELIVERABLE_ACTOR",
    "load_actor",
]

# the stage-1 SAC deliverable's actor, exported by tools/export_torch_actor.py
DELIVERABLE_ACTOR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.realpath(__file__))), "assets",
    "deliverable_sac_stage1_actor.npz")
_META_KEYS = ("obs_res", "frame_stack")


def load_actor(path: Optional[str] = None, device=None,
               compute_dtype=torch.bfloat16) -> SquashedGaussianActor:
    """The SAC actor stored in an exported ``.npz`` (default: the shipped
    deliverable), in eval mode on ``device`` (default: the GPU)."""
    dev = resolve_device(device)
    with np.load(path or DELIVERABLE_ACTOR) as z:
        obs_res, frame_stack = (int(z[k]) for k in _META_KEYS)
        state = {k: torch.from_numpy(z[k]) for k in z.files
                 if k not in _META_KEYS}
    actor = SquashedGaussianActor(in_channels=3 * frame_stack,
                                  obs_res=obs_res, compute_dtype=compute_dtype)
    actor.load_state_dict(state)
    return actor.to(dev).eval()
