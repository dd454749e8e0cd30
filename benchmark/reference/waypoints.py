"""Waypoint reach logic (the benchmark's reference: a frozen copy of
the port's ``ops/waypoints.py``):
the current target ``waypoints[target_idx]`` is reached when the ego center
is within 3 m of it."""

from __future__ import annotations

import torch

REACH_RADIUS = 3.0  # meters


def waypoint_reached(ego_xy: torch.Tensor, waypoints: torch.Tensor,
                     target_idx: torch.Tensor,
                     n_waypoints: torch.Tensor) -> torch.Tensor:
    """ego_xy (B, 2), waypoints (B, W, 2), target_idx (B,), n_waypoints (B,)
    -> (B,) bool: the current target exists and is within REACH_RADIUS."""
    w = waypoints.shape[-2]
    idx = torch.clamp(target_idx, 0, w - 1).long()
    target = torch.gather(waypoints, -2, idx[:, None, None].expand(-1, 1, 2))[:, 0]
    valid = target_idx < n_waypoints
    d = ego_xy - target
    dist = torch.sqrt((d * d).sum(dim=-1))
    return valid & (dist < REACH_RADIUS)
