"""Device-resident map / scenario arrays and their samplers.

Port of ``torchdriveenv_tpu/maps/arrays.py``. The same compiled asset files
(``torchdriveenv_tpu/assets/*.npz``) load into tensors of the same dtypes,
with one exception: ``npc_field`` is uint32 on disk and loads as int64,
since torch's uint32 supports few operations (``sample_npc_field`` takes the
bit fields apart with int64 shifts and masks).

Samplers take ``town`` with a shape that is a prefix of ``xy.shape[:-1]``
(one town per env, broadcast over that env's points), where the JAX
samplers take a scalar town under ``vmap``.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from typing import Optional

import numpy as np
import torch

import torchdriveenv_tpu_torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU. No CUDA device is an error, never a silent
    fall back to the CPU: the CPU runs only when asked for by name."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, device: torch.device,
                    dtype=torch.float32) -> torch.Tensor:
    """A small constant (nested tuples of numbers) as a tensor on ``device``,
    uploaded once and shared by every caller, which must not write to it.
    Building it anew at each call is a host-to-device copy, and that
    synchronizes the host with the device: in an env step, a stall per
    constant."""
    return torch.tensor(values, dtype=dtype, device=device)


@dataclasses.dataclass
class MapArrays:
    """Per-town raster geometry, padded over towns (T towns, G x G grid)."""

    scale: torch.Tensor          # () meters per pixel
    origin: torch.Tensor         # (T, 2) world coords of pixel (0, 0) corner
    sdf: torch.Tensor            # (T, G, G) f32 signed distance, + inside
    dir_angle: torch.Tensor      # (T, G, G) f32 lane direction (radians)
    sdf_gx: torch.Tensor         # (T, G, G) f16 d(sdf)/dx
    sdf_gy: torch.Tensor         # (T, G, G) f16 d(sdf)/dy
    npc_field: torch.Tensor      # (T, G, G) int64 packed (dir f16, gx u8, gy u8)
    seg_data: torch.Tensor       # (T, C, C, K, 8) f32 per-cell corridor segments
    seg_cell_n: torch.Tensor     # (T, C, C) int32 valid rows per cell
    seg_cell: torch.Tensor       # () cell size in meters
    stop_p0: torch.Tensor        # (T, L, 2)
    stop_p1: torch.Tensor        # (T, L, 2)
    stop_dir: torch.Tensor       # (T, L) approach heading (radians)
    light_phase: torch.Tensor    # (T, L) seconds
    light_mask: torch.Tensor     # (T, L) bool
    light_durations: torch.Tensor  # (3,) green / yellow / red seconds


@dataclasses.dataclass
class SuiteArrays:
    case_town: torch.Tensor      # (C,) int32
    waypoints: torch.Tensor      # (C, W, 2)
    waypoint_mask: torch.Tensor  # (C, W) bool
    n_waypoints: torch.Tensor    # (C,) int32
    scen_states: torch.Tensor    # (C, S, 4) [x, y, psi, speed]
    scen_attrs: torch.Tensor     # (C, S, 3) [length, width, rear_axis_offset]
    scen_mask: torch.Tensor      # (C, S) bool
    replay_states: torch.Tensor  # (C, 1+S, RT, 4)
    replay_mask: torch.Tensor    # (C, 1+S, RT) bool


@dataclasses.dataclass
class BackgroundArrays:
    bg_states: torch.Tensor      # (T, F, A, 4)
    bg_attrs: torch.Tensor       # (T, F, A, 3)
    bg_mask: torch.Tensor        # (T, F, A) bool
    bg_density: torch.Tensor     # (T, F) int32
    bg_valid: torch.Tensor       # (T, F) bool


@dataclasses.dataclass
class Assets:
    maps: MapArrays
    suite: SuiteArrays
    background: BackgroundArrays

    @property
    def device(self) -> torch.device:
        return self.maps.sdf.device


_SUITE_DTYPES = dict(
    case_town=torch.int32, waypoints=torch.float32, waypoint_mask=torch.bool,
    n_waypoints=torch.int32, scen_states=torch.float32,
    scen_attrs=torch.float32, scen_mask=torch.bool,
    replay_states=torch.float32, replay_mask=torch.bool)


def suite_from_numpy(s, device) -> SuiteArrays:
    """``SuiteArrays`` on ``device`` from a mapping of numpy arrays (an npz
    bundle, or what ``maps/compile.py:compile_suite`` returns)."""
    return SuiteArrays(**{
        k: torch.as_tensor(np.asarray(s[k]), device=device).to(dtype)
        for k, dtype in _SUITE_DTYPES.items()})


def _assets_dir() -> str:
    return torchdriveenv_tpu_torch._data_path[0]


def load_assets(suite: str = "train", device=None,
                assets_dir: Optional[str] = None) -> Assets:
    """Load the compiled asset bundles onto ``device`` (default: the GPU).

    suite: "train" (100 cases) or "val" (the 5 validation scenarios).
    """
    dev = resolve_device(device)
    d = assets_dir or _assets_dir()
    m = np.load(os.path.join(d, "maps_v1.npz"))
    s = np.load(os.path.join(d, f"suite_{suite}_v1.npz"))
    b = np.load(os.path.join(d, "background_v1.npz"))

    def t(arr, dtype):
        return torch.as_tensor(np.asarray(arr), device=dev).to(dtype)

    maps = MapArrays(
        scale=t(m["scale"], torch.float32),
        origin=t(m["origin"], torch.float32),
        sdf=t(m["sdf"], torch.float32),
        dir_angle=t(m["dir_angle"], torch.float32),
        sdf_gx=t(m["sdf_gx"], torch.float16),
        sdf_gy=t(m["sdf_gy"], torch.float16),
        npc_field=t(m["npc_field"].astype(np.int64), torch.int64),
        seg_data=t(m["seg_data"], torch.float32),
        seg_cell_n=t(m["seg_cell_n"], torch.int32),
        seg_cell=t(m["seg_cell"], torch.float32),
        stop_p0=t(m["stop_p0"], torch.float32),
        stop_p1=t(m["stop_p1"], torch.float32),
        stop_dir=t(m["stop_dir"], torch.float32),
        light_phase=t(m["light_phase"], torch.float32),
        light_mask=t(m["light_mask"], torch.bool),
        light_durations=t(m["light_durations"], torch.float32),
    )
    suite_arrays = suite_from_numpy(s, dev)
    background = BackgroundArrays(
        bg_states=t(b["bg_states"], torch.float32),
        bg_attrs=t(b["bg_attrs"], torch.float32),
        bg_mask=t(b["bg_mask"], torch.bool),
        bg_density=t(b["bg_density"], torch.int32),
        bg_valid=t(b["bg_valid"], torch.bool),
    )
    return Assets(maps=maps, suite=suite_arrays, background=background)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def _town_index(town: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """town (a prefix of xy's point dims) -> int64 index shaped xy[..., 0]."""
    town = torch.as_tensor(town, device=xy.device)
    extra = xy.dim() - 1 - town.dim()
    return town.long().reshape(town.shape + (1,) * extra).expand(xy.shape[:-1])


def _pixel_coords(maps: MapArrays, town: torch.Tensor, xy: torch.Tensor):
    """World xy (..., 2) -> continuous pixel coords in the town grid."""
    return (xy - maps.origin[town]) / maps.scale - 0.5


def _gather_town_grid(grid: torch.Tensor, town: torch.Tensor,
                      ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """grid[town, ix, iy] elementwise over the query points (never a
    per-env (G, G) slice)."""
    return grid[town, ix.long(), iy.long()]


def _nearest_index(maps: MapArrays, grid: torch.Tensor, town, xy):
    g = grid.shape[-1]
    tw = _town_index(town, xy)
    p = _pixel_coords(maps, tw, xy)
    i = torch.clamp(torch.round(p).to(torch.int32), 0, g - 1)
    return tw, i[..., 0], i[..., 1]


def sample_sdf(maps: MapArrays, town, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of the drivable-area SDF (meters, + inside) at world
    coords xy (..., 2). Returns (...,)."""
    g = maps.sdf.shape[-1]
    tw = _town_index(town, xy)
    p = _pixel_coords(maps, tw, xy)
    p = torch.clamp(p, 0.0, g - 1.001)
    i0 = torch.floor(p).to(torch.int32)
    f = p - i0.to(torch.float32)
    i1 = torch.clamp(i0 + 1, max=g - 1)
    v00 = _gather_town_grid(maps.sdf, tw, i0[..., 0], i0[..., 1]).float()
    v01 = _gather_town_grid(maps.sdf, tw, i0[..., 0], i1[..., 1]).float()
    v10 = _gather_town_grid(maps.sdf, tw, i1[..., 0], i0[..., 1]).float()
    v11 = _gather_town_grid(maps.sdf, tw, i1[..., 0], i1[..., 1]).float()
    fx, fy = f[..., 0], f[..., 1]
    return ((v00 * (1 - fx) + v10 * fx) * (1 - fy)
            + (v01 * (1 - fx) + v11 * fx) * fy)


def sample_sdf_nearest(maps: MapArrays, town, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor SDF sample (meters, + inside)."""
    tw, ix, iy = _nearest_index(maps, maps.sdf, town, xy)
    return _gather_town_grid(maps.sdf, tw, ix, iy).float()


def sample_sdf_grad(maps: MapArrays, town, xy: torch.Tensor):
    """Nearest-neighbor SDF gradient sample -> (gx, gy) each (...,)."""
    tw, ix, iy = _nearest_index(maps, maps.sdf_gx, town, xy)
    gx = _gather_town_grid(maps.sdf_gx, tw, ix, iy)
    gy = _gather_town_grid(maps.sdf_gy, tw, ix, iy)
    return gx.float(), gy.float()


def sample_npc_field(maps: MapArrays, town, xy: torch.Tensor):
    """One nearest-neighbor gather of the packed control field ->
    (dir_angle, sdf_gx, sdf_gy), each (...,)."""
    tw, ix, iy = _nearest_index(maps, maps.npc_field, town, xy)
    u = _gather_town_grid(maps.npc_field, tw, ix, iy)        # int64
    # low 16 bits are an f16: wrap to int16 and reinterpret the bits
    dir_angle = (u & 0xFFFF).to(torch.int16).view(torch.float16).float()
    gx = (((u >> 16) & 0xFF).to(torch.float32) - 128.0) / 32.0
    gy = (((u >> 24) & 0xFF).to(torch.float32) - 128.0) / 32.0
    return dir_angle, gx, gy


def sample_dir_angle(maps: MapArrays, town, xy: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor sample of the lane direction field (radians)."""
    tw, ix, iy = _nearest_index(maps, maps.dir_angle, town, xy)
    return _gather_town_grid(maps.dir_angle, tw, ix, iy).float()
