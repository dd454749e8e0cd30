"""Egocentric birdview from the SDF grid (port of
``torchdriveenv_tpu/ops/rasterizer.py``), and the palette and culling
constants the CUDA rasterizer shares.

``render_egocentric`` paints, per pixel: background, road where the
nearest-neighbour SDF sample is positive, the waypoint discs, the stoplines
tinted by light state (the nearest line that covers a pixel wins), the NPC
boxes, then the ego box. It is the renderer of the Gym adapter's
observation and of its high-resolution video; the batched env's observation
is the analytic road of ``ops/rasterizer_cuda.py``. The JAX function is
plain XLA, so this one is plain torch, batched over a leading env axis
where the JAX code ``vmap``s: every per-pixel test is the same elementwise
expression in the same operand order, culls pick with a stable sort (the
tie order of ``lax.top_k``), and the SDF index rounds half to even.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torchdriveenv_tpu_torch.maps.arrays import (
    MapArrays,
    device_constant,
    sample_sdf_nearest,
)
from torchdriveenv_tpu_torch.ops.traffic_lights import light_states_at

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


def pixel_world_coords(ego_state: torch.Tensor, res: int, fov: float,
                       left_handed: bool) -> torch.Tensor:
    """World coordinates (B, res, res, 2) of every pixel centre of B frames,
    ego_state (B, 4): the ego centred, its heading pointing up (row 0)."""
    m_per_px = fov / res
    idx = (torch.arange(res, dtype=torch.float32, device=ego_state.device)
           - (res - 1) / 2.0) * m_per_px
    rows, cols = torch.meshgrid(idx, idx, indexing="ij")
    forward = -rows            # up on screen = +forward
    right = -cols if left_handed else cols
    psi = ego_state[:, 2]
    f = torch.stack([torch.cos(psi), torch.sin(psi)], dim=-1)[:, None, None]
    r = torch.stack([torch.sin(psi), -torch.cos(psi)], dim=-1)[:, None, None]
    return (ego_state[:, None, None, :2]
            + forward[None, ..., None] * f
            + right[None, ..., None] * r)


def obb_coverage(points: torch.Tensor, states: torch.Tensor,
                 sizes: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """points (B, r, r, 2) vs boxes (B, K, 4) / (B, K, 2) / (B, K) ->
    (B, r, r) bool: inside any masked box."""
    d = points[..., None, :] - states[:, None, None, :, :2]    # (B, r, r, K, 2)
    psi = states[:, None, None, :, 2]
    c, s = torch.cos(psi), torch.sin(psi)
    lx = d[..., 0] * c + d[..., 1] * s
    ly = -d[..., 0] * s + d[..., 1] * c
    inside = ((torch.abs(lx) <= sizes[:, None, None, :, 0] / 2.0)
              & (torch.abs(ly) <= sizes[:, None, None, :, 1] / 2.0)
              & mask[:, None, None, :])
    return inside.any(dim=-1)


def segment_distance2(points: torch.Tensor, p0: torch.Tensor,
                      p1: torch.Tensor) -> torch.Tensor:
    """points (B, r, r, 2) vs segments (B, L, 2) -> (B, r, r, L) SQUARED
    distances (callers compare against squared thresholds)."""
    seg = (p1 - p0)[:, None, None]                             # (B, 1, 1, L, 2)
    inv_len2 = 1.0 / torch.clamp((seg * seg).sum(dim=-1), min=1e-9)
    rel = points[..., None, :] - p0[:, None, None]
    t = torch.clamp((rel * seg).sum(dim=-1) * inv_len2, 0.0, 1.0)
    proj = rel - t[..., None] * seg
    return (proj * proj).sum(dim=-1)


def render_egocentric(maps: MapArrays, town: torch.Tensor, t: torch.Tensor,
                      agent_states: torch.Tensor, agent_attrs: torch.Tensor,
                      present: torch.Tensor, waypoints: torch.Tensor,
                      target_idx: torch.Tensor, n_waypoints: torch.Tensor,
                      res: int = 64, fov: float = 70.0,
                      left_handed: bool = True,
                      highlight_ego: bool = True) -> torch.Tensor:
    """Render B envs' egocentric birdviews -> (B, 3, res, res) uint8.

    town, t, target_idx, n_waypoints (B,); agent_states (B, A, 4),
    agent_attrs (B, A, 3), present (B, A), waypoints (B, W, 2). Every
    waypoint but index 0 is drawn all episode, so ``target_idx`` does not
    change the frame; it stays in the signature like the JAX code's.
    """
    del target_idx
    dev = agent_states.device
    tw = town.long()
    ego = agent_states[:, 0]
    pts = pixel_world_coords(ego, res, fov, left_handed)       # (B, r, r, 2)
    ninf = torch.full((), -float("inf"), device=dev)

    # road: the nearest SDF sample of each pixel centre
    road = sample_sdf_nearest(maps, town, pts) > 0.0

    # waypoints: the nearest visible discs
    w = waypoints.shape[1]
    wp_ids = torch.arange(w, device=dev)
    wp_mask = (wp_ids >= 1) & (wp_ids < n_waypoints[:, None])
    dwp = waypoints - ego[:, None, :2]
    wp_d2 = (dwp * dwp).sum(dim=-1)
    wp_half_diag = fov * 0.7071 + WAYPOINT_RADIUS
    wp_visible = wp_mask & (wp_d2 < wp_half_diag * wp_half_diag)
    w_top = top_k_indices(torch.where(wp_visible, -wp_d2, ninf),
                          min(RENDER_MAX_WAYPOINTS, w))
    d_wp = pts[..., None, :] - take_rows(waypoints, w_top)[:, None, None]
    wp_hit = (((d_wp * d_wp).sum(dim=-1) < WAYPOINT_RADIUS * WAYPOINT_RADIUS)
              & torch.gather(wp_visible, 1, w_top)[:, None, None]).any(dim=-1)

    # stoplines tinted by live light state: the nearest visible lights
    p0_all, p1_all = maps.stop_p0[tw], maps.stop_p1[tw]            # (B, L, 2)
    dl = (p0_all + p1_all) * 0.5 - ego[:, None, :2]
    l_d2 = (dl * dl).sum(dim=-1)
    half_diag = fov * 0.7071 + 8.0
    l_visible = maps.light_mask[tw] & (l_d2 < half_diag * half_diag)
    l_top = top_k_indices(torch.where(l_visible, -l_d2, ninf),
                          min(RENDER_MAX_LIGHTS, p0_all.shape[1]))
    sl_hit = ((segment_distance2(pts, take_rows(p0_all, l_top),
                                 take_rows(p1_all, l_top))
               < STOPLINE_HALF_THICK * STOPLINE_HALF_THICK)
              & torch.gather(l_visible, 1, l_top)[:, None, None])
    states_l = torch.gather(light_states_at(maps, town, t), 1, l_top)
    sl_any = sl_hit.any(dim=-1)
    first = torch.argmax(sl_hit.to(torch.uint8), dim=-1)        # first hit wins
    sl_state = torch.gather(states_l, 1, first.flatten(1)).reshape(first.shape)
    palette = device_constant(COLOR_LIGHT, dev)                 # [state, channel]
    sl_color = palette[torch.clamp(sl_state, 0, 2).long()].permute(0, 3, 1, 2)

    # agent boxes: the nearest visible NPCs, then the ego on top
    sizes = agent_attrs[..., :2]
    a = agent_states.shape[1]
    npc_mask = present & (torch.arange(a, device=dev) > 0)
    half_diag = fov * 0.7071 + 4.0
    da = agent_states[..., :2] - ego[:, None, :2]
    d2 = (da * da).sum(dim=-1)
    visible = npc_mask & (d2 < half_diag * half_diag)
    top = top_k_indices(torch.where(visible, -d2, ninf),
                        min(RENDER_MAX_AGENTS, a))
    npc_hit = obb_coverage(pts, take_rows(agent_states, top),
                           take_rows(sizes, top), torch.gather(visible, 1, top))
    ego_hit = obb_coverage(pts, agent_states[:, :1], sizes[:, :1],
                           present[:, :1])

    def c(color):
        return device_constant(color, dev)[:, None, None]       # (3, 1, 1)

    b = agent_states.shape[0]
    img = c(COLOR_BACKGROUND).expand(b, 3, res, res)
    img = torch.where(road[:, None], c(COLOR_ROAD), img)
    img = torch.where(wp_hit[:, None], c(COLOR_WAYPOINT), img)
    img = torch.where(sl_any[:, None], sl_color, img)
    img = torch.where(npc_hit[:, None], c(COLOR_NPC), img)
    img = torch.where(ego_hit[:, None],
                      c(COLOR_EGO if highlight_ego else COLOR_NPC), img)
    return img.to(torch.uint8)


def observation_shape(res: int = 64) -> Tuple[int, int, int]:
    """The observation space Box(0, 255, (3, res, res)) (reference
    gym_env.py:95)."""
    return (3, res, res)
