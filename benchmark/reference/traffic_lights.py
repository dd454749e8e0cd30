"""Traffic-light state machine and stopline violation test (the benchmark's reference: a frozen copy of
the port's ``ops/traffic_lights.py``).

Each light cycles green -> yellow -> red with a fixed period and a per-light
phase offset. A violation is an agent's front bumper crossing a red
stopline this step while heading within 90 degrees of its approach
direction. All functions take one town and time per env, ``town (B,)``.
"""

from __future__ import annotations

import enum

import torch

from .arrays import MapArrays


class LightState(enum.IntEnum):
    GREEN = 0
    YELLOW = 1
    RED = 2


def light_states_at(maps: MapArrays, town: torch.Tensor,
                    t: torch.Tensor) -> torch.Tensor:
    """town (...), t (...) seconds -> light states (..., L) int32."""
    g, y, r = (maps.light_durations[0], maps.light_durations[1],
               maps.light_durations[2])
    period = g + y + r
    # torch.remainder floors like jnp.mod (torch.fmod would truncate)
    phase = torch.remainder(t[..., None] + maps.light_phase[town.long()], period)
    states = torch.where(phase < g, int(LightState.GREEN),
                         torch.where(phase < g + y, int(LightState.YELLOW),
                                     int(LightState.RED)))
    return states.to(torch.int32)


def traffic_light_violation(maps: MapArrays, town: torch.Tensor,
                            t: torch.Tensor, prev_state: torch.Tensor,
                            state: torch.Tensor,
                            size: torch.Tensor) -> torch.Tensor:
    """1.0 where the agent's front bumper crossed a red stopline this step.

    town (B,), t (B,), prev_state / state (B, 4), size (B, 2) -> (B,) f32.
    """
    tw = town.long()
    red = light_states_at(maps, town, t) == int(LightState.RED)   # (B, L)

    stop_dir = maps.stop_dir[tw]                                  # (B, L)
    dx, dy = torch.cos(stop_dir), torch.sin(stop_dir)
    nx, ny = -dy, dx
    p0, p1 = maps.stop_p0[tw], maps.stop_p1[tw]                   # (B, L, 2)
    mid = (p0 + p1) / 2.0
    seg = p1 - p0
    half_len = torch.sqrt((seg * seg).sum(dim=-1)) / 2.0          # (B, L)

    def front(s):
        half = size[:, 0] / 2.0
        fx = s[:, 0] + half * torch.cos(s[:, 2])
        fy = s[:, 1] + half * torch.sin(s[:, 2])
        return fx[:, None], fy[:, None]

    px, py = front(prev_state)
    qx, qy = front(state)
    s_prev = (px - mid[..., 0]) * dx + (py - mid[..., 1]) * dy
    s_new = (qx - mid[..., 0]) * dx + (qy - mid[..., 1]) * dy
    lat = torch.abs((qx - mid[..., 0]) * nx + (qy - mid[..., 1]) * ny)
    crossed = ((s_prev < 0.0) & (s_new >= 0.0)
               & (lat < half_len + size[:, 1:2] / 2.0))
    aligned = torch.cos(state[:, 2:3] - stop_dir) > 0.0
    hit = maps.light_mask[tw] & red & crossed & aligned
    return hit.any(dim=-1).to(torch.float32)
