"""Deterministic IDM route-follower NPCs (port of
``torchdriveenv_tpu/npc/route_follow.py``).

NPCs follow the compiled lane direction field with an IDM longitudinal
controller, keep off road edges using the SDF gradient, brake for leaders
and for non-green stoplines. Everything is batched over ``(B, A)``.

``nearest_obstacles`` gives the controller its nearest obstacle and stopline
ahead: on the card by the hand-written kernel ``csrc/npc_gaps.cu``, which
keeps the pairs on chip; on the CPU by the plain twins ``leader_gaps`` and
``light_gaps``, which build ``(B, A, A)`` and ``(B, A, L)`` tiles.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from torchdriveenv_tpu_torch.maps.arrays import MapArrays, exact_div, sample_npc_field
from torchdriveenv_tpu_torch.ops import _build
from torchdriveenv_tpu_torch.ops.traffic_lights import LightState, light_states_at

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
SAME_DIR_COS = -0.2     # a leader's heading differs by under ~102 degrees
EMERG_BASE = 10.0       # emergency range at standstill, before the floor
EMERG_LAT_SLOPE = 0.1   # the emergency cone widens this much a metre ahead
CLOSING_FLOOR = 1e-3    # least closing speed in the time to closest approach
TC_MAX = 4.0            # longest time to closest approach looked at
ONCOMING_COS = -0.5     # oncoming: headings differ by over 120 degrees
ONCOMING_LAT = 2.0      # an oncoming miss closer than this brakes
CLOSING_MIN = 0.5       # ... when closing faster than this
LIGHT_RANGE = 30.0
LIGHT_LAT = 4.0
ALIGNED_COS = 0.5       # a stopline applies within 60 degrees of its heading
STOP_MARGIN = 1.0       # stop this far short of the line

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
    same_dir = cospsi > SAME_DIR_COS
    pair = present[:, None, :] & present[:, :, None] & (lon > 0.0)
    # cruising leader: same-direction traffic ahead in my lane corridor
    is_leader = (pair & (lon < LEADER_RANGE)
                 & (torch.abs(lat) < LEADER_LAT) & same_dir)
    # emergency obstacle: anything directly ahead at short range, in a cone
    emerg_d = torch.clamp(EMERG_BASE + EMERG_HEADWAY * v,
                          min=EMERG_RANGE)[..., None]
    emerg_lat = EMERG_LAT + EMERG_LAT_SLOPE * lon
    in_cone = torch.abs(lat) < emerg_lat
    # oncoming pairs brake only on a predicted miss inside one lane width
    velx, vely = v * fx, v * fy
    vrelx = velx[:, None, :] - velx[:, :, None]
    vrely = vely[:, None, :] - vely[:, :, None]
    vrel_lon = vrelx * fx[..., None] + vrely * fy[..., None]
    vrel_lat = vrelx * lx[..., None] + vrely * ly[..., None]
    closing = -vrel_lon
    tc = torch.clamp(lon / torch.clamp(closing, min=CLOSING_FLOOR), 0.0, TC_MAX)
    lat_pred = lat + vrel_lat * tc
    oncoming = cospsi < ONCOMING_COS
    oncoming_hit = ((torch.abs(lat_pred) < ONCOMING_LAT)
                    & (closing > CLOSING_MIN))
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
    aligned = torch.cos(psi[..., None] - maps.stop_dir[tw][:, None, :]) > ALIGNED_COS
    sl_active = (maps.light_mask[tw][:, None, :] & red[:, None, :] & aligned
                 & (sl_lon > 0.0) & (sl_lon < LIGHT_RANGE)
                 & (torch.abs(sl_lat) < LIGHT_LAT))
    sl_gap = sl_lon - length[..., None] / 2.0 - STOP_MARGIN
    return torch.where(sl_active, sl_gap, torch.full_like(sl_gap, math.inf))


def light_gaps(maps: MapArrays, town: torch.Tensor, t: torch.Tensor,
               states: torch.Tensor, attrs: torch.Tensor) -> torch.Tensor:
    """Distance to the nearest blocking (non-green) stopline per agent,
    +inf when none applies. -> (B, A)."""
    return stopline_gaps(maps, town, t, states, attrs).amin(dim=-1)


@functools.lru_cache(maxsize=None)
def _kernel_params():
    """The kernel's f32 constants in its ``Params`` order: those of
    ``obstacle_gaps`` and ``stopline_gaps``, rounded as torch rounds them."""
    vals = [LEADER_RANGE, LEADER_LAT, SAME_DIR_COS, EMERG_BASE, EMERG_HEADWAY,
            EMERG_RANGE, EMERG_LAT, EMERG_LAT_SLOPE, CLOSING_FLOOR, TC_MAX,
            ONCOMING_COS, ONCOMING_LAT, CLOSING_MIN, LIGHT_RANGE, LIGHT_LAT,
            ALIGNED_COS, STOP_MARGIN]
    return (ctypes.c_float * len(vals))(*np.asarray(vals, np.float32).tolist())


_check = functools.partial(_build.check_tensor, "npc_gaps_cuda")


def npc_gaps_cuda(maps: MapArrays, town: torch.Tensor, red: torch.Tensor,
                  states: torch.Tensor, attrs: torch.Tensor,
                  present: torch.Tensor):
    """Launch the kernel of ``csrc/npc_gaps.cu`` on CUDA tensors, on the
    current stream -> (leader_gap, leader_v, light_gap), each (B, A) f32.
    ``red`` (B, L) bool: the stoplines whose light is not green. Raises on
    tensors elsewhere than the GPU, on any other dtype, shape or layout, on a
    failed build and on a failed launch. ``npc_gaps_cuda.launches`` counts
    the launches from the host (a replayed CUDA graph adds none)."""
    dev = states.device
    if dev.type != "cuda":
        raise ValueError("npc_gaps_cuda needs CUDA tensors; got "
                         f"{dev} (use leader_gaps and light_gaps on the CPU)")
    b, a = states.shape[:2]
    n_town, n_lights = maps.stop_dir.shape
    _check("states", states, torch.float32, (b, a, 4), dev)
    _check("attrs", attrs, torch.float32, (b, a, attrs.shape[-1]), dev)
    _check("present", present, torch.bool, (b, a), dev)
    _check("town", town, torch.int32, (b,), dev)
    _check("red", red, torch.bool, (b, n_lights), dev)
    _check("stop_p0", maps.stop_p0, torch.float32, (n_town, n_lights, 2), dev)
    _check("stop_p1", maps.stop_p1, torch.float32, (n_town, n_lights, 2), dev)
    _check("stop_dir", maps.stop_dir, torch.float32, (n_town, n_lights), dev)
    _check("light_mask", maps.light_mask, torch.bool, (n_town, n_lights), dev)
    out = torch.empty((3, b, a), dtype=torch.float32, device=dev)
    if b == 0 or a == 0:
        return out[0], out[1], out[2]
    lib = _build.load_npc_gaps()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tde_npc_gaps(
            states.data_ptr(), attrs.data_ptr(), present.data_ptr(),
            town.data_ptr(), red.data_ptr(), maps.stop_p0.data_ptr(),
            maps.stop_p1.data_ptr(), maps.stop_dir.data_ptr(),
            maps.light_mask.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            out[2].data_ptr(), b, a, attrs.shape[-1], n_lights,
            _kernel_params(), stream)
    if rc != 0:
        raise RuntimeError(f"npc_gaps kernel launch failed: CUDA error {rc} "
                           f"({lib.tde_npc_gaps_error_string(rc).decode()})")
    npc_gaps_cuda.launches += 1
    return out[0], out[1], out[2]


npc_gaps_cuda.launches = 0    # kernel launches since the last reset to 0


def nearest_obstacles(maps: MapArrays, town: torch.Tensor, t: torch.Tensor,
                      states: torch.Tensor, attrs: torch.Tensor,
                      present: torch.Tensor):
    """Nearest obstacle and blocking stopline ahead of every agent ->
    (leader_gap (B, A), leader_v (B, A), light_gap (B, A)): what
    ``leader_gaps`` and ``light_gaps`` return, bit for bit; by the kernel
    for CUDA inputs, by those twins for CPU inputs."""
    if not states.is_cuda:
        leader_gap, leader_v = leader_gaps(states, attrs, present)
        return leader_gap, leader_v, light_gaps(maps, town, t, states, attrs)
    red = light_states_at(maps, town, t) != int(LightState.GREEN)
    return npc_gaps_cuda(maps, town, red, states.contiguous(),
                         attrs.contiguous(), present.contiguous())


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
    leader_gap, leader_v, light_gap = nearest_obstacles(
        maps, town, t, states, attrs, present)

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
