"""The benchmark's reference: the batched env's birdview.

A frozen copy of the plain part of the port's ``ops/rasterizer_cuda.py``,
which later changes to the port do not reach: ``prepare_obs_inputs``
culls and packs each env's render inputs into fixed blocks;
``render_obs_torch``, the plain twin of the port's CUDA kernel, paints per
pixel the background, the analytic road (within ``sign(hw)*hw^2`` of a
corridor segment of the ego cell's list), waypoint discs, stoplines tinted
by light state (nearest wins), NPC boxes, then the ego box.
``cull_masks_torch`` is the plain version of the kernel's cull
predicates, which the yardstick's ``render_cost`` counts the kernel's
least work with.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .arrays import MapArrays, device_constant
from .rasterizer import (
    COLOR_BACKGROUND,
    COLOR_EGO,
    COLOR_LIGHT,
    COLOR_NPC,
    COLOR_ROAD,
    COLOR_WAYPOINT,
    RENDER_MAX_AGENTS,
    RENDER_MAX_LIGHTS,
    RENDER_MAX_WAYPOINTS,
    STOPLINE_HALF_THICK,
    WAYPOINT_RADIUS,
    take_rows,
    top_k_indices,
)
from .traffic_lights import light_states_at

SEG_CHUNK = 8       # segments per vectorized step of the twin
KERNEL_RES = 64     # the kernel's pixel layout: 4 x 4 tiles of CULL_TILE^2
CULL_TILE = 16      # side of a cull tile in pixels (one warp per tile)
CULL_MARGIN = 0.25  # metres added to every cull radius (kCullMargin)

# f32 operations per pixel of a render, for ``render_cost``; each
# elementwise operation counts one:
# the road test of one segment: 2 sub, 2 mul, add, mul, 2 clamp, 2 mul,
# 2 sub, 2 mul, add, compare, or
ROAD_OPS = 17
# the pixel's world centre: 2 sub, 2 mul, 2 negate, 4 mul, 4 add or sub
PIXEL_CENTRE_OPS = 14
# one waypoint disc: 2 sub, 2 mul, add, 2 compare, and
DISC_OPS = 8
# one NPC box: 2 sub, 4 mul, 2 add, negate, 2 abs, 3 compare, 2 and, or
BOX_OPS = 17
# the ego box: 2 sub, 4 mul, 2 add, negate, 2 abs, 2 compare, and
EGO_BOX_OPS = 14
# one stopline: 2 sub, 2 mul, add, mul, 2 clamp, 2 mul, 2 sub, 2 mul, add,
# 2 compare, and
STOPLINE_OPS = 18
# the overlay, a channel: road, disc, stopline, NPC and ego selects, the
# cast to uint8
SELECT_OPS = 3 * 6
# every primitive of the blocks on a pixel: 8 discs, 16 boxes, the ego, 4
# stoplines
COMPOSITE_OPS = (PIXEL_CENTRE_OPS + 8 * DISC_OPS + 16 * BOX_OPS + EGO_BOX_OPS
                 + 4 * STOPLINE_OPS + SELECT_OPS)


# ---------------------------------------------------------------------------
# per-env cull & pack (plain torch; shared by the kernel and its twin)
# ---------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[1]))


def prepare_obs_inputs(maps: MapArrays, town: torch.Tensor, t: torch.Tensor,
                       agent_states: torch.Tensor, agent_attrs: torch.Tensor,
                       present: torch.Tensor, waypoints: torch.Tensor,
                       target_idx: torch.Tensor, n_waypoints: torch.Tensor,
                       fov: float):
    """Cull and pack the render inputs of B envs into fixed blocks.

    Returns (ci, cj, nseg (B,) int32, env_block (B, 8, 8),
             agent_block (B, 16, 8), wp_block (B, 8, 8)):
      env_block row 0: ego [x, y, cos, sin, half_len, half_wid, 0, 0]
      env_block rows 2..5: stoplines [p0x, p0y, p1x, p1y, r, g, b, active]
      agent_block rows: NPCs [x, y, cos, sin, half_len, half_wid, present, 0]
      wp_block rows: waypoints [x, y, valid, 0, ...]
    ``target_idx`` does not affect the frame (every waypoint but index 0 is
    drawn all episode); it stays in the signature like the JAX code's.
    """
    del target_idx
    dev = agent_states.device
    b = town.shape[0]
    tw = town.long()
    ego = agent_states[:, 0]
    c_ego, s_ego = torch.cos(ego[:, 2]), torch.sin(ego[:, 2])
    ninf = torch.full((), -float("inf"), device=dev)

    # waypoints: the nearest visible discs
    w = waypoints.shape[1]
    wp_ids = torch.arange(w, device=dev)
    wp_mask = (wp_ids >= 1) & (wp_ids < n_waypoints[:, None])
    dwp = waypoints - ego[:, None, :2]
    wp_d2 = (dwp * dwp).sum(dim=-1)
    wp_half_diag = fov * 0.7071 + WAYPOINT_RADIUS
    wp_visible = wp_mask & (wp_d2 < wp_half_diag * wp_half_diag)
    wk = min(RENDER_MAX_WAYPOINTS, w)
    w_top = top_k_indices(torch.where(wp_visible, -wp_d2, ninf), wk)
    wp_rows = torch.cat([
        take_rows(waypoints, w_top),
        torch.gather(wp_visible, 1, w_top)[..., None].to(torch.float32),
        torch.zeros(b, wk, 5, device=dev)], dim=-1)
    wp_block = _pad_rows(wp_rows, 8)

    # stoplines: the nearest visible lights
    p0_all, p1_all = maps.stop_p0[tw], maps.stop_p1[tw]            # (B, L, 2)
    mid = (p0_all + p1_all) * 0.5
    dl = mid - ego[:, None, :2]
    l_d2 = (dl * dl).sum(dim=-1)
    half_diag_l = fov * 0.7071 + 8.0
    l_visible = maps.light_mask[tw] & (l_d2 < half_diag_l * half_diag_l)
    lk = min(RENDER_MAX_LIGHTS, p0_all.shape[1])
    l_top = top_k_indices(torch.where(l_visible, -l_d2, ninf), lk)
    states_l = torch.gather(light_states_at(maps, town, t), 1, l_top)
    palette = device_constant(COLOR_LIGHT, dev)
    sl_color = palette[torch.clamp(states_l, 0, 2).long()]         # (B, lk, 3)
    sl_rows = torch.cat([
        take_rows(p0_all, l_top), take_rows(p1_all, l_top), sl_color,
        torch.gather(l_visible, 1, l_top)[..., None].to(torch.float32)], dim=-1)
    sl_rows = _pad_rows(sl_rows, 4)

    # agents: the nearest visible NPCs
    a = agent_states.shape[1]
    npc_mask = present & (torch.arange(a, device=dev) > 0)
    half_diag_a = fov * 0.7071 + 4.0
    da = agent_states[..., :2] - ego[:, None, :2]
    d2 = (da * da).sum(dim=-1)
    visible = npc_mask & (d2 < half_diag_a * half_diag_a)
    k = min(RENDER_MAX_AGENTS, a)
    top = top_k_indices(torch.where(visible, -d2, ninf), k)
    st, at = take_rows(agent_states, top), take_rows(agent_attrs, top)
    agent_block = torch.stack([
        st[..., 0], st[..., 1], torch.cos(st[..., 2]), torch.sin(st[..., 2]),
        at[..., 0] * 0.5, at[..., 1] * 0.5,
        torch.gather(visible, 1, top).to(torch.float32),
        torch.zeros(b, k, device=dev)], dim=-1)
    agent_block = _pad_rows(agent_block, 16)

    zero = torch.zeros(b, device=dev)
    ego_row = torch.stack([
        ego[:, 0], ego[:, 1], c_ego, s_ego,
        agent_attrs[:, 0, 0] * 0.5, agent_attrs[:, 0, 1] * 0.5, zero, zero],
        dim=-1)
    env_block = torch.cat([ego_row[:, None], torch.zeros(b, 1, 8, device=dev),
                           sl_rows, torch.zeros(b, 2, 8, device=dev)], dim=1)

    # coarse segment-index cell of the ego (truncation toward zero, then clip)
    cgrid = maps.seg_cell_n.shape[-1]
    cell = ((ego[:, :2] - maps.origin[tw]) / maps.seg_cell).to(torch.int32)
    cell = torch.clamp(cell, 0, cgrid - 1)
    ci, cj = cell[:, 0].contiguous(), cell[:, 1].contiguous()
    nseg = maps.seg_cell_n[tw, ci.long(), cj.long()]
    return ci, cj, nseg, env_block, agent_block, wp_block


# ---------------------------------------------------------------------------
# the plain twin: per-pixel math over (B, res, res)
# ---------------------------------------------------------------------------


def _col(x: torch.Tensor) -> torch.Tensor:
    """(B, ...) per-env values -> broadcastable against (B, ..., res, res)."""
    return x[..., None, None]


def _pixel_world(ego_row, res: int, fov: float, left_handed: bool,
                 img_row, img_col):
    """World coords (B, res, res) of pixel centers, ego row (B, 8)."""
    m_per_px = fov / res
    fwd = -(img_row - (res - 1) / 2.0) * m_per_px
    rgt = (img_col - (res - 1) / 2.0) * m_per_px
    if left_handed:
        rgt = -rgt
    ex, ey, c, s = (_col(ego_row[:, 0]), _col(ego_row[:, 1]),
                    _col(ego_row[:, 2]), _col(ego_row[:, 3]))
    px = ex + fwd * c + rgt * s
    py = ey + fwd * s - rgt * c
    return px, py


def _seg_hits(chunk, px, py):
    """chunk (B, n, 8) segment rows vs px/py (B, h, w) -> (B, n, h, w)."""
    ax, ay = _col(chunk[..., 0]), _col(chunk[..., 1])
    sx, sy = _col(chunk[..., 2]) - ax, _col(chunk[..., 3]) - ay
    shw2 = _col(chunk[..., 4])
    inv_len2 = torch.reciprocal(torch.clamp(sx * sx + sy * sy, min=1e-9))
    relx = px[:, None] - ax
    rely = py[:, None] - ay
    tt = torch.clamp((relx * sx + rely * sy) * inv_len2, 0.0, 1.0)
    dx = relx - tt * sx
    dy = rely - tt * sy
    return dx * dx + dy * dy <= shw2


def _seg_chunk_hit(chunk, px, py):
    """-> (B, h, w): within any segment of the chunk."""
    return _seg_hits(chunk, px, py).any(dim=1)


def _obb_hits(rows, px, py):
    """rows (B, n, 8) agent rows vs px/py (B, h, w) -> (B, n, h, w)."""
    relx = px[:, None] - _col(rows[..., 0])
    rely = py[:, None] - _col(rows[..., 1])
    c, s = _col(rows[..., 2]), _col(rows[..., 3])
    lx = relx * c + rely * s
    ly = -relx * s + rely * c
    return ((torch.abs(lx) <= _col(rows[..., 4]))
            & (torch.abs(ly) <= _col(rows[..., 5]))
            & (_col(rows[..., 6]) > 0.0))


def _obb_hit(rows, px, py):
    """-> (B, h, w): covered by any present box."""
    return _obb_hits(rows, px, py).any(dim=1)


def _seg_dist2_scalar(p0x, p0y, p1x, p1y, px, py):
    """Segments p0-p1 vs points px/py (broadcast against each other; the
    composite passes one segment per env, (B, 1, 1) each) -> squared
    distance."""
    sx, sy = p1x - p0x, p1y - p0y
    inv_len2 = torch.reciprocal(torch.clamp(sx * sx + sy * sy, min=1e-9))
    relx, rely = px - p0x, py - p0y
    tt = torch.clamp((relx * sx + rely * sy) * inv_len2, 0.0, 1.0)
    dx, dy = relx - tt * sx, rely - tt * sy
    return dx * dx + dy * dy


def _wp_hits(wp_block, px, py):
    """wp_block (B, W, 8) rows [x, y, valid, ...] -> (B, W, h, w)."""
    dx = px[:, None] - _col(wp_block[..., 0])
    dy = py[:, None] - _col(wp_block[..., 1])
    return ((dx * dx + dy * dy < WAYPOINT_RADIUS * WAYPOINT_RADIUS)
            & (_col(wp_block[..., 2]) > 0.0))


def _wp_hit(wp_block, px, py):
    """-> (B, h, w): inside any valid disc."""
    return _wp_hits(wp_block, px, py).any(dim=1)


def _ego_hit(ego_row, px, py):
    """ego_row (B, 8) vs px/py (B, h, w) -> (B, h, w) covered by the ego."""
    relx, rely = px - _col(ego_row[:, 0]), py - _col(ego_row[:, 1])
    lx = relx * _col(ego_row[:, 2]) + rely * _col(ego_row[:, 3])
    ly = -relx * _col(ego_row[:, 3]) + rely * _col(ego_row[:, 2])
    return ((torch.abs(lx) <= _col(ego_row[:, 4]))
            & (torch.abs(ly) <= _col(ego_row[:, 5])))


def _stopline_hits(env_block, px, py):
    """env_block rows 2..5 vs px/py (B, h, w) -> 4 x (B, h, w) on-the-line."""
    thick2 = STOPLINE_HALF_THICK * STOPLINE_HALF_THICK
    hits = []
    for k_sl in range(RENDER_MAX_LIGHTS):
        sl = [_col(env_block[:, 2 + k_sl, j]) for j in range(8)]
        d2 = _seg_dist2_scalar(sl[0], sl[1], sl[2], sl[3], px, py)
        hits.append((d2 < thick2) & (sl[7] > 0.0))
    return hits


def _composite(px, py, road, env_block, agent_block, wp_block,
               highlight_ego: bool):
    """Overlay stack -> 3 float planes shaped like px."""
    wp_hit = _wp_hit(wp_block, px, py)
    npc_hit = _obb_hit(agent_block, px, py)
    ego_hit = _ego_hit(env_block[:, 0], px, py)
    sl_hits = _stopline_hits(env_block, px, py)
    ego_color = COLOR_EGO if highlight_ego else COLOR_NPC
    chans = []
    for ch in range(3):
        v = torch.full(px.shape, COLOR_BACKGROUND[ch], device=px.device)
        v = torch.where(road, COLOR_ROAD[ch], v)
        v = torch.where(wp_hit, COLOR_WAYPOINT[ch], v)
        # reverse order => nearest stopline wins on overlap
        for k_sl in range(RENDER_MAX_LIGHTS - 1, -1, -1):
            v = torch.where(sl_hits[k_sl], _col(env_block[:, 2 + k_sl, 4 + ch]),
                            v)
        v = torch.where(npc_hit, COLOR_NPC[ch], v)
        v = torch.where(ego_hit, ego_color[ch], v)
        chans.append(v)
    return chans


def render_obs_torch(maps: MapArrays, town, ci, cj, nseg, env_block,
                     agent_block, wp_block, res: int = 64, fov: float = 70.0,
                     left_handed: bool = True,
                     highlight_ego: bool = True) -> torch.Tensor:
    """Plain twin of the kernel (and of the JAX ``render_obs_ref``), batched:
    -> (B, 3, res, res) uint8. Scans every row of each env's segment list;
    rows past ``nseg`` never hit (their ``sign(hw)*hw^2`` is negative)."""
    del nseg
    seg = maps.seg_data[town.long(), ci.long(), cj.long()]        # (B, K, 8)
    idx = torch.arange(res, dtype=torch.float32, device=env_block.device)
    img_row, img_col = torch.meshgrid(idx, idx, indexing="ij")
    px, py = _pixel_world(env_block[:, 0], res, fov, left_handed,
                          img_row, img_col)
    road = torch.zeros(px.shape, dtype=torch.bool, device=px.device)
    for s0 in range(0, seg.shape[1], SEG_CHUNK):
        road |= _seg_chunk_hit(seg[:, s0:s0 + SEG_CHUNK], px, py)
    chans = _composite(px, py, road, env_block, agent_block, wp_block,
                       highlight_ego)
    return torch.stack(chans, dim=1).to(torch.uint8)


# ---------------------------------------------------------------------------
# the plain version of the kernel's cull
# ---------------------------------------------------------------------------


class CullMasks(NamedTuple):
    """What the kernel keeps; T = 16 tiles, tile ``4 * (row // 16) + col // 16``."""

    frame: torch.Tensor      # (B, K) bool: segment rows staged for the frame
    seg: torch.Tensor        # (B, T, K) bool: ... and tested on the tile
    agent: torch.Tensor      # (B, T, 16) bool
    wp: torch.Tensor         # (B, T, 8) bool
    stopline: torch.Tensor   # (B, T, 4) bool
    ego: torch.Tensor        # (B, T) bool


def cull_masks_torch(maps: MapArrays, town, ci, cj, nseg, env_block,
                     agent_block, wp_block, res: int = 64, fov: float = 70.0,
                     left_handed: bool = True,
                     margin: float = CULL_MARGIN) -> CullMasks:
    """The cull predicates of ``csrc/rasterizer.cu`` in plain torch.

    A primitive is kept for the frame (a tile) when its distance from the
    frame's (tile's) centre is at most its own reach plus the half-diagonal
    between the frame's (tile's) outermost pixel centres plus ``margin``.
    Half-diagonals scale with the length of the ego's (cos, sin) row, and a
    box's centre distance with the length of its own, so the predicates
    stay conservative for rows that are not unit vectors. The env step
    never calls this function; ``render_cost`` counts the kernel's work
    with it.
    """
    seg = maps.seg_data[town.long(), ci.long(), cj.long()]        # (B, K, 8)
    ego = env_block[:, 0]
    ego_n2 = ego[:, 2] * ego[:, 2] + ego[:, 3] * ego[:, 3]
    ego_n = torch.sqrt(ego_n2)
    m_per_px = fov / res
    r_frame = (res - 1) / 2.0 * m_per_px * math.sqrt(2.0) * ego_n + margin
    r_tile = ((CULL_TILE - 1) / 2.0 * m_per_px * math.sqrt(2.0) * ego_n
              + margin)[:, None]                                   # (B, 1)

    # tile centres (B, T), in the kernel's tile order
    centre = (torch.arange(res // CULL_TILE, dtype=torch.float32,
                           device=env_block.device) * CULL_TILE
              + (CULL_TILE - 1) / 2.0)
    c_row, c_col = torch.meshgrid(centre, centre, indexing="ij")
    tcx, tcy = _pixel_world(ego, res, fov, left_handed, c_row, c_col)
    tcx, tcy = tcx.flatten(1)[:, :, None], tcy.flatten(1)[:, :, None]

    shw2 = seg[..., 4]
    listed = (torch.arange(seg.shape[1], device=seg.device)
              < torch.clamp(nseg, 0, seg.shape[1])[:, None]) & (shw2 >= 0.0)
    hw = torch.sqrt(torch.clamp(shw2, min=0.0))
    ends = [seg[..., j] for j in range(4)]
    d2_frame = _seg_dist2_scalar(*ends, ego[:, 0:1], ego[:, 1:2])
    frame = listed & (d2_frame <= (hw + r_frame[:, None]) ** 2)
    d2_tile = _seg_dist2_scalar(*(e[:, None] for e in ends), tcx, tcy)
    seg_tile = frame[:, None] & (d2_tile <= (hw + r_tile)[:, None] ** 2)

    def centre_d2(rows):
        dx, dy = tcx - rows[:, None, :, 0], tcy - rows[:, None, :, 1]
        return dx * dx + dy * dy                                   # (B, T, n)

    def box_reach(rows):
        """(B, n, 8) box rows [x, y, cos, sin, half_len, half_wid, ...]."""
        n2 = rows[..., 2] * rows[..., 2] + rows[..., 3] * rows[..., 3]
        lim = (torch.sqrt(rows[..., 4] * rows[..., 4]
                          + rows[..., 5] * rows[..., 5])
               + r_tile * torch.sqrt(n2))
        return centre_d2(rows) * n2[:, None] <= (lim * lim)[:, None]

    agent = (agent_block[:, None, :, 6] > 0.0) & box_reach(agent_block)
    wp = ((wp_block[:, None, :, 2] > 0.0)
          & (centre_d2(wp_block) <= ((WAYPOINT_RADIUS + r_tile) ** 2)[:, None]))
    sl = env_block[:, 2:2 + RENDER_MAX_LIGHTS]
    d2_sl = _seg_dist2_scalar(*(sl[:, None, :, j] for j in range(4)), tcx, tcy)
    stopline = ((sl[:, None, :, 7] > 0.0)
                & (d2_sl <= ((STOPLINE_HALF_THICK + r_tile) ** 2)[:, None]))
    return CullMasks(frame=frame, seg=seg_tile, agent=agent, wp=wp,
                     stopline=stopline, ego=box_reach(ego[:, None])[..., 0])
