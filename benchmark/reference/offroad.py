"""Offroad test against the drivable-area SDF (the benchmark's reference: a frozen copy of
the port's ``ops/offroad.py``): how far the deepest corner of the
agent's box sits outside the drivable region (meters), 0 when on-road."""

from __future__ import annotations

import torch

from .arrays import MapArrays, sample_sdf
from .collision import obb_corners


def compute_offroad(maps: MapArrays, town: torch.Tensor, states: torch.Tensor,
                    sizes: torch.Tensor) -> torch.Tensor:
    """town (B,), states (B, ..., 4), sizes (B, ..., 2) -> (B, ...) >= 0."""
    corners = obb_corners(states, sizes)          # (B, ..., 4, 2)
    sdf = sample_sdf(maps, town, corners)         # (B, ..., 4)
    return torch.clamp(-sdf.amin(dim=-1), min=0.0)
