"""The benchmark's reference: the birdview's palette and culling constants
and the stable top-k, a frozen copy of the port's ``ops/rasterizer.py``
(the part the batched env's observation uses).
"""

from __future__ import annotations

import torch


# palette (RGB, 0..255)
COLOR_BACKGROUND = (15.0, 15.0, 20.0)
COLOR_ROAD = (90.0, 90.0, 95.0)
COLOR_WAYPOINT = (40.0, 220.0, 90.0)
COLOR_NPC = (60.0, 120.0, 235.0)
COLOR_EGO = (230.0, 60.0, 50.0)
COLOR_LIGHT = ((40.0, 200.0, 60.0),     # green
               (235.0, 200.0, 40.0),    # yellow
               (235.0, 50.0, 40.0))     # red
WAYPOINT_RADIUS = 2.0      # meters
STOPLINE_HALF_THICK = 0.7  # meters
RENDER_MAX_AGENTS = 16     # per-pixel OBB tests after visibility culling
RENDER_MAX_LIGHTS = 4      # per-pixel stopline tests after visibility culling
RENDER_MAX_WAYPOINTS = 8   # per-pixel disc tests after visibility culling


def top_k_indices(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest along the last axis, ties to the lower index
    (``lax.top_k``'s order; ``torch.topk`` promises none)."""
    return torch.sort(key, dim=-1, descending=True, stable=True).indices[..., :k]


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows idx (B, k) -> (B, k, ...)."""
    shape = idx.shape + x.shape[2:]
    flat_idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(shape)
    return torch.gather(x, 1, flat_idx)
