"""Deterministic IDM route-follower NPCs (the benchmark's reference: a frozen copy of
the port's ``npc/route_follow.py``).

NPCs follow the compiled lane direction field with an IDM longitudinal
controller, keep off road edges using the SDF gradient, brake for leaders
and for non-green stoplines. Everything is batched over ``(B, A)``; the
pairwise leader search builds ``(B, A, A)`` tiles.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .arrays import MapArrays, exact_div, sample_npc_field
from .traffic_lights import LightState, light_states_at

# IDM parameters (standard motorway values, Treiber et al. 2000)
IDM_A_MAX = 2.0
IDM_B = 3.0
IDM_S0 = 2.5
IDM_T = 1.5
ACCEL_BOUNDS = (-4.0, 2.0)
STEER_BOUND = 0.35
LEADER_RANGE = 60.0
LEADER_LAT = 2.5
EMERG_RANGE = 16.0
EMERG_HEADWAY = 1.8
EMERG_LAT = 3.0
LANE_OFFSET = 1.75
LIGHT_RANGE = 30.0
LIGHT_LAT = 4.0

# 2 * sqrt(a * b) rounded as the JAX code rounds it: an f32 sqrt of an f32
_IDM_DENOM = float(np.float32(2.0) * np.sqrt(np.float32(IDM_A_MAX * IDM_B)))


def _wrap(a):
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def obstacle_gaps(states: torch.Tensor, attrs: torch.Tensor,
                  present: torch.Tensor):
    """Gaps to every obstacle ahead -> (gap_ij (B, A, A), +inf where j is
    not an obstacle of i; the cosines of the heading differences (B, A, A)).

    states (B, A, 4), attrs (B, A, 3), present (B, A). Index i is the
    agent, j the candidate obstacle.
    """
    px, py, psi, v = (states[..., 0], states[..., 1], states[..., 2],
                      states[..., 3])
    length = attrs[..., 0]
    fx, fy = torch.cos(psi), torch.sin(psi)
    lx, ly = -torch.sin(psi), torch.cos(psi)
    relx = px[:, None, :] - px[:, :, None]                # (B, i, j)
    rely = py[:, None, :] - py[:, :, None]
    lon = relx * fx[..., None] + rely * fy[..., None]
    lat = relx * lx[..., None] + rely * ly[..., None]
    cospsi = torch.cos(psi[:, None, :] - psi[:, :, None])
    same_dir = cospsi > -0.2
    pair = present[:, None, :] & present[:, :, None] & (lon > 0.0)
    # cruising leader: same-direction traffic ahead in my lane corridor
    is_leader = (pair & (lon < LEADER_RANGE)
                 & (torch.abs(lat) < LEADER_LAT) & same_dir)
    # emergency obstacle: anything directly ahead at short range, in a cone
    emerg_d = torch.clamp(10.0 + EMERG_HEADWAY * v, min=EMERG_RANGE)[..., None]
    emerg_lat = EMERG_LAT + 0.1 * lon
    in_cone = torch.abs(lat) < emerg_lat
    # oncoming pairs brake only on a predicted miss inside one lane width
    velx, vely = v * fx, v * fy
    vrelx = velx[:, None, :] - velx[:, :, None]
    vrely = vely[:, None, :] - vely[:, :, None]
    vrel_lon = vrelx * fx[..., None] + vrely * fy[..., None]
    vrel_lat = vrelx * lx[..., None] + vrely * ly[..., None]
    closing = -vrel_lon
    tc = torch.clamp(lon / torch.clamp(closing, min=1e-3), 0.0, 4.0)
    lat_pred = lat + vrel_lat * tc
    oncoming = cospsi < -0.5
    oncoming_hit = (torch.abs(lat_pred) < 2.0) & (closing > 0.5)
    is_emerg = (pair & (lon < emerg_d)
                & torch.where(oncoming, oncoming_hit, in_cone))
    a = states.shape[1]
    noself = ~torch.eye(a, dtype=torch.bool, device=states.device)
    is_obst = (is_leader | is_emerg) & noself
    gap_ij = lon - (length[:, :, None] + length[:, None, :]) / 2.0
    gap_ij = torch.where(is_obst, gap_ij, torch.full_like(gap_ij, math.inf))
    return gap_ij, cospsi


def leader_gaps(states: torch.Tensor, attrs: torch.Tensor,
                present: torch.Tensor):
    """Nearest obstacle ahead per agent -> (gap (B, A), leader_v (B, A)).
    gap is +inf when no leader is in range."""
    gap_ij, cospsi = obstacle_gaps(states, attrs, present)
    v = states[..., 3]
    # argmin returns the first minimum, as jnp.argmin does; an exact gather
    # of the j_star column equals the JAX code's one-hot masked sum
    gap = gap_ij.amin(dim=2)
    j_star = gap_ij.argmin(dim=2, keepdim=True)
    v_proj = torch.gather(v[:, None, :] * cospsi, 2, j_star)[..., 0]
    leader_v = torch.where(torch.isfinite(gap), v_proj, torch.zeros_like(v_proj))
    return gap, leader_v


def stopline_gaps(maps: MapArrays, town: torch.Tensor, t: torch.Tensor,
                  states: torch.Tensor, attrs: torch.Tensor) -> torch.Tensor:
    """Distance to every blocking (non-green) stopline ahead per agent,
    +inf where it does not apply. town (B,), t (B,), states (B, A, 4) ->
    (B, A, L)."""
    tw = town.long()
    px, py, psi = states[..., 0], states[..., 1], states[..., 2]
    length = attrs[..., 0]
    fx, fy = torch.cos(psi), torch.sin(psi)
    lx, ly = -torch.sin(psi), torch.cos(psi)
    sl_mid = (maps.stop_p0[tw] + maps.stop_p1[tw]) / 2.0          # (B, L, 2)
    relx = sl_mid[:, None, :, 0] - px[..., None]                  # (B, A, L)
    rely = sl_mid[:, None, :, 1] - py[..., None]
    sl_lon = relx * fx[..., None] + rely * fy[..., None]
    sl_lat = relx * lx[..., None] + rely * ly[..., None]
    red = light_states_at(maps, town, t) != int(LightState.GREEN)  # (B, L)
    aligned = torch.cos(psi[..., None] - maps.stop_dir[tw][:, None, :]) > 0.5
    sl_active = (maps.light_mask[tw][:, None, :] & red[:, None, :] & aligned
                 & (sl_lon > 0.0) & (sl_lon < LIGHT_RANGE)
                 & (torch.abs(sl_lat) < LIGHT_LAT))
    sl_gap = sl_lon - length[..., None] / 2.0 - 1.0
    return torch.where(sl_active, sl_gap, torch.full_like(sl_gap, math.inf))


def light_gaps(maps: MapArrays, town: torch.Tensor, t: torch.Tensor,
               states: torch.Tensor, attrs: torch.Tensor) -> torch.Tensor:
    """Distance to the nearest blocking (non-green) stopline per agent,
    +inf when none applies. -> (B, A)."""
    return stopline_gaps(maps, town, t, states, attrs).amin(dim=-1)


def npc_actions(maps: MapArrays, town: torch.Tensor, t: torch.Tensor,
                states: torch.Tensor, attrs: torch.Tensor,
                present: torch.Tensor,
                target_speed: torch.Tensor) -> torch.Tensor:
    """(B, A, 2) [accel, steering] for all agents (the caller masks the ego).

    states (B, A, 4), attrs (B, A, 3), present (B, A), target_speed (B, A)
    desired cruise speed (0 = parked).
    """
    px, py, psi, v = (states[..., 0], states[..., 1], states[..., 2],
                      states[..., 3])
    fx, fy = torch.cos(psi), torch.sin(psi)
    lx, ly = -torch.sin(psi), torch.cos(psi)

    # lateral control: track the direction field at a probe offset to the
    # agent's right, and keep the probe off the road edges
    lookahead = torch.clamp(v * 0.6, min=3.0)
    probe = torch.stack([px + fx * lookahead - lx * LANE_OFFSET,
                         py + fy * lookahead - ly * LANE_OFFSET], dim=-1)
    dir_tgt, gx, gy = sample_npc_field(maps, town, probe)
    # the field is a line field: oncoming traffic follows it reversed
    heading_err = _wrap(dir_tgt - psi)
    heading_err = torch.where(torch.abs(heading_err) > math.pi / 2,
                              _wrap(heading_err + math.pi), heading_err)
    edge_err = torch.clamp(0.24 * (gx * lx + gy * ly), -0.2, 0.2)
    steer = torch.clamp(1.5 * heading_err + edge_err, -STEER_BOUND, STEER_BOUND)

    # longitudinal control: IDM against the nearest leader; non-green
    # stoplines are stationary obstacles
    leader_gap, leader_v = leader_gaps(states, attrs, present)
    light_gap = light_gaps(maps, town, t, states, attrs)

    use_light = light_gap < leader_gap
    gap = torch.where(use_light, light_gap, leader_gap)
    lead_speed = torch.where(use_light, torch.zeros_like(leader_v), leader_v)
    gap = torch.clamp(gap, min=0.1)

    # curvature comfort cap (lateral accel ~3 m/s^2 over the ~6 m lookahead)
    v_curve = torch.sqrt(3.0 * 6.0 / torch.clamp(torch.abs(heading_err), min=0.05))
    v0 = torch.clamp(torch.minimum(target_speed, v_curve), min=0.1)
    dv = v - lead_speed
    s_star = IDM_S0 + v * IDM_T + exact_div(v * dv, _IDM_DENOM)
    s_star = torch.clamp(s_star, min=0.0)
    ratio = s_star / gap
    interaction = torch.where(torch.isfinite(gap), ratio * ratio,
                              torch.zeros_like(ratio))
    # (x*x)*(x*x): the JAX code's integer_pow(x, 4), not a pow() call
    r = torch.clamp(v, min=0.0) / v0
    r2 = r * r
    accel = IDM_A_MAX * (1.0 - r2 * r2 - interaction)
    accel = torch.clamp(accel, *ACCEL_BOUNDS)

    # parked agents hold still; nobody reverses
    parked = target_speed < 0.1
    accel = torch.where(parked, torch.clamp(-4.0 * v, *ACCEL_BOUNDS), accel)
    steer = torch.where(parked, torch.zeros_like(steer), steer)
    accel = torch.maximum(accel, exact_div(-v, 0.1))
    return torch.stack([accel, steer], dim=-1)
