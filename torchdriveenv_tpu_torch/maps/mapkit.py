"""The offline map compiler's grid passes: the CUDA kernels, their plain
twins and the dispatchers (port of ``torchdriveenv_tpu/maps/native.py``,
whose C++ is ``csrc/mapkit.cpp``).

``stamp_segments`` rasterizes road-corridor segments into a (G, G) grid:
``drivable`` where a pixel center lies within a segment's half width, and
the direction of the closest segment per pixel. ``edt`` is the exact
Euclidean distance transform with the flat index of the nearest source.
``sdf`` (two EDTs and a select) and ``propagate_dir`` (one EDT and a gather)
are plain torch on their outputs.

On a CUDA tensor each dispatcher launches the hand-written kernels of
``csrc/mapkit.cu`` and counts its kernel launches
(``stamp_segments_cuda.launches``, one a stamp: each 16 x 16 tile walks
only the segments whose windows meet it; ``edt_cuda.launches``, two an
EDT: the column pass's sweeps, then the row pass's exact lower envelopes).
On a CPU tensor it runs the plain twin
(``stamp_segments_torch``, ``edt_torch``), written the way the kernel
computes. Nothing falls back. ``stamp_tile_hits_torch`` is the stamp
kernel's tile predicate in plain torch: change it together with the
``.cu``.

Bit-equality of kernel and twin:
  - stamp: the per-segment table (double endpoints, the clamped pixel
    window, the float direction) is computed once on the host in float64
    (``segment_table``), the arithmetic of ``csrc/mapkit.cpp``; the per-pixel
    arithmetic is the same double expression in both, in segment order, and
    the source is built with ``--fmad=false``.
  - edt: squared distances are integers (< 2^31), the kernel's envelope
    compares its breakpoints as exact rationals; the tie rule is pinned:
    the smaller source row in the column pass (the one above), then the
    smallest column in the row pass.
Pixel (i, j) is the world point origin + (i + 0.5, j + 0.5) * scale: i runs
along x, j along y, row-major (i * G + j).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from torchdriveenv_tpu_torch.ops import _build

NO_SOURCE = 1 << 30       # squared distance of a line without a source
NO_SOURCE_DIST = 1e20     # mapkit.cpp's kInf: distance sqrt(1e20) without one
EDT_CHUNK = 16            # rows per step of the twin's row pass
MAX_EDT_GRID = 8192       # the kernel's squared distances stay below 2^31
STAMP_TILE = 16           # pixels per side of a stamp kernel block


def ieee_sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the kernels' ``sqrt``. torch's
    CPU ``sqrt`` is a vectorized approximation (on an AVX-512 host about one
    float64 result in 140 is an ulp off C's and numpy's), so on the CPU this
    is numpy's; on CUDA, torch's (IEEE)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


def _host_f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


# ---------------------------------------------------------------------------
# corridor stamping
# ---------------------------------------------------------------------------


def segment_table(grid: int, origin, scale: float, p0, p1, halfwidth):
    """Per-segment constants of the stamp, on the host in float64, as
    ``mapkit_stamp_segments`` computes them.

    The origin and the scale enter as float32 (``native.py`` passes them
    through a C float), then widen to double. Returns
    (geom (n, 6) float64 [ax, ay, sx, sy, len2, hw2],
     win (n, 5) int32 [i0, j0, i1, j1, has_dir] (the clamped pixel window,
     i1 / j1 exclusive),
     ang (n,) float32, ox, oy, sc (the widened origin and scale)).
    """
    ox, oy = (float(np.float32(v)) for v in np.asarray(origin).reshape(2))
    sc = float(np.float32(scale))
    a, b = _host_f64(p0).reshape(-1, 2), _host_f64(p1).reshape(-1, 2)
    hw = _host_f64(halfwidth).reshape(-1)
    n = hw.shape[0]
    geom = np.zeros((n, 6), np.float64)
    win = np.zeros((n, 5), np.int32)
    ang = np.zeros((n,), np.float32)
    for s in range(n):
        ax, ay = float(a[s, 0]), float(a[s, 1])
        bx, by = float(b[s, 0]), float(b[s, 1])
        h = float(hw[s])
        sx, sy = bx - ax, by - ay
        len2 = sx * sx + sy * sy
        has_dir = len2 > 1e-12
        if has_dir:
            ang[s] = math.atan2(sy, sx)
        i0 = max(int((min(ax, bx) - h - ox) / sc) - 1, 0)
        j0 = max(int((min(ay, by) - h - oy) / sc) - 1, 0)
        i1 = min(int((max(ax, bx) + h - ox) / sc) + 2, grid)
        j1 = min(int((max(ay, by) + h - oy) / sc) + 2, grid)
        geom[s] = (ax, ay, sx, sy, len2, h * h)
        win[s] = (i0, j0, i1, j1, int(has_dir))
    return geom, win, ang, ox, oy, sc


def _check_grids(grid, drivable, dir_best_d, dir_angle):
    for name, t, dtype in (("drivable", drivable, torch.uint8),
                           ("dir_best_d", dir_best_d, torch.float32),
                           ("dir_angle", dir_angle, torch.float32)):
        if (t.shape != (grid, grid) or t.dtype != dtype
                or not t.is_contiguous() or t.device != drivable.device):
            raise ValueError(f"{name}: want a contiguous ({grid}, {grid}) "
                             f"{dtype} on {drivable.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def stamp_tile_hits_torch(grid: int, win) -> torch.Tensor:
    """The stamp kernel's tile predicate: (tiles, tiles, n) bool, True
    where segment s's non-empty clamped window ``win[s, :4]`` ([i0, j0, i1,
    j1), from ``segment_table``) meets tile (ti, tj), the pixels
    [16 ti, 16 ti + 16) x [16 tj, 16 tj + 16). A tile's list is its True
    entries in input order. Nothing on the GPU path calls this function."""
    w = torch.as_tensor(np.asarray(win)[:, :4], dtype=torch.int64)
    i0, j0, i1, j1 = w.unbind(1)
    lo = torch.arange(0, grid, STAMP_TILE, dtype=torch.int64)[:, None]
    hi = lo + STAMP_TILE
    rows = (i0 < hi) & (i1 > lo) & (i0 < i1)          # (tiles, n)
    cols = (j0 < hi) & (j1 > lo) & (j0 < j1)
    return rows[:, None, :] & cols[None, :, :]


def one_tile_segments(n: int):
    """An edge case of the stamp's order rule, for checks: n short segments
    (p0, p1, halfwidth) on one line through one tile, every other one
    reversed, shifted along the line by whole pixels at 0.5 m a pixel.
    Where they overlap their distances are equal, so input order decides
    ``dir_angle``."""
    a = np.tile([[-25.0, -26.0]], (n, 1))
    b = np.tile([[-21.0, -26.0]], (n, 1))
    a[1::2], b[1::2] = b[1::2].copy(), a[1::2].copy()
    shift = (np.arange(n) % 5)[:, None] * np.array([[0.5, 0.0]])
    return a + shift, b + shift, np.full(n, 1.5)


def tile_border_segments(rng: np.random.Generator, n: int, tiles: int):
    """An edge case of the stamp's tile predicate, for checks: n segments
    (p0, p1, halfwidth) whose clamped windows (origin 0, 0.5 m a pixel,
    half width 1 m) lie in the first ``tiles`` tiles and end on tile
    borders: a low end of 8 a + 1.5 m gives i0 = 16 a, a high end of
    8 b - 2 m gives i1 = 16 b (half a metre off: one pixel off the
    border)."""
    lo = rng.integers(0, tiles - 1, (n, 2))
    hi = lo + rng.integers(1, 3, (n, 2))
    off = rng.choice([-0.5, 0.0, 0.0, 0.5], (n, 2))
    p0 = 8.0 * lo + 1.5 + off
    p1 = 8.0 * hi - 2.0 - off[:, ::-1]
    flip = rng.random(n) < 0.5
    p0[flip], p1[flip] = p1[flip].copy(), p0[flip].copy()
    return p0, p1, np.full(n, 1.0)


def stamp_segments_torch(grid: int, origin, scale: float, p0, p1, halfwidth,
                         drivable: torch.Tensor, dir_best_d: torch.Tensor,
                         dir_angle: torch.Tensor) -> None:
    """The plain twin of the stamp kernel, in place: each segment in input
    order over its window, the double arithmetic of ``mapkit.cpp``."""
    _check_grids(grid, drivable, dir_best_d, dir_angle)
    geom, win, ang, ox, oy, sc = segment_table(grid, origin, scale, p0, p1,
                                               halfwidth)
    dev = drivable.device
    for s in range(geom.shape[0]):
        i0, j0, i1, j1, has_dir = (int(v) for v in win[s])
        if i0 >= i1 or j0 >= j1:
            continue
        ax, ay, sx, sy, len2, hw2 = (float(v) for v in geom[s])
        ii = torch.arange(i0, i1, dtype=torch.float64, device=dev)
        jj = torch.arange(j0, j1, dtype=torch.float64, device=dev)
        px = ((ox + (ii + 0.5) * sc) - ax)[:, None]
        py = ((oy + (jj + 0.5) * sc) - ay)[None, :]
        if has_dir:
            t = torch.clamp((px * sx + py * sy) / len2, 0.0, 1.0)
        else:
            t = torch.zeros((), dtype=torch.float64, device=dev)
        dx = px - t * sx
        dy = py - t * sy
        d2 = dx * dx + dy * dy
        drv = drivable[i0:i1, j0:j1]
        drv[d2 <= hw2] = 1
        if has_dir:
            d = ieee_sqrt(d2).to(torch.float32)
            best = dir_best_d[i0:i1, j0:j1]
            closer = d < best
            best[closer] = d[closer]
            dir_angle[i0:i1, j0:j1][closer] = float(ang[s])


def _packed_table(geom, win, ang) -> torch.Tensor:
    """The segment table as ``tde_stamp_segments`` reads it, in pinned
    host memory: 72 bytes a segment, win (n, 4) int32 at 0, geom (n, 6)
    float64 at 16 n, ang (n,) float32 at 64 n, has_dir (n,) int32 at 68 n."""
    n = geom.shape[0]
    host = torch.empty(max(72 * n, 16), dtype=torch.uint8, pin_memory=True)
    buf = host.numpy()
    buf[:16 * n].view(np.int32)[:] = win[:, :4].reshape(-1)
    buf[16 * n:64 * n].view(np.float64)[:] = geom.reshape(-1)
    buf[64 * n:68 * n].view(np.float32)[:] = ang
    buf[68 * n:72 * n].view(np.int32)[:] = win[:, 4]
    return host


def stamp_segments_cuda(grid: int, origin, scale: float, p0, p1, halfwidth,
                        drivable: torch.Tensor, dir_best_d: torch.Tensor,
                        dir_angle: torch.Tensor, table=None) -> None:
    """The stamp on the card, in place: the segment table (``table``, else
    ``segment_table`` of the arguments) packed in pinned memory and
    uploaded in one copy on the current stream, then the kernel
    (``tde_stamp_segments``) launched on that stream and counted
    (``stamp_segments_cuda.launches``). Raises if the launch is refused."""
    _check_grids(grid, drivable, dir_best_d, dir_angle)
    dev = drivable.device
    if dev.type != "cuda" or grid < 1:
        raise ValueError("the stamp kernel takes a non-empty grid of CUDA "
                         "tensors")
    if table is None:
        table = segment_table(grid, origin, scale, p0, p1, halfwidth)
    geom, win, ang, ox, oy, sc = table
    lib = _build.load_mapkit()
    with torch.cuda.device(dev):
        packed = _packed_table(geom, win, ang).to(dev, non_blocking=True)
        code = lib.tde_stamp_segments(
            grid, ox, oy, sc, packed.data_ptr(), geom.shape[0],
            drivable.data_ptr(), dir_best_d.data_ptr(), dir_angle.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError("tde_stamp_segments launch failed: "
                           + lib.tde_mapkit_error_string(code).decode())
    stamp_segments_cuda.launches += 1


stamp_segments_cuda.launches = 0


def stamp_segments(grid: int, origin, scale: float, p0, p1, halfwidth,
                   drivable: torch.Tensor, dir_best_d: torch.Tensor,
                   dir_angle: torch.Tensor) -> None:
    """In-place corridor stamp of n segments into (grid, grid) layers:
    ``drivable`` (uint8) set where a pixel center is within ``halfwidth``
    of segment p0-p1; where a segment of non-zero length is closer than
    ``dir_best_d`` (float32, start it at 1e9), that distance and the
    segment's direction (``dir_angle``, float32). ``p0``, ``p1`` (n, 2) and
    ``halfwidth`` (n,) are arrays or tensors, read as float64. The kernel
    on a CUDA grid, the twin on a CPU one."""
    fn = (stamp_segments_cuda if drivable.device.type == "cuda"
          else stamp_segments_torch)
    fn(grid, origin, scale, p0, p1, halfwidth, drivable, dir_best_d,
       dir_angle)


# ---------------------------------------------------------------------------
# exact Euclidean distance transform
# ---------------------------------------------------------------------------


def _check_source(source: torch.Tensor) -> int:
    g = source.shape[0]
    if source.dim() != 2 or source.shape[1] != g:
        raise ValueError(f"edt takes a square grid, got {tuple(source.shape)}")
    return g


def edt_torch(source: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain twin of the EDT kernel: a column pass (the nearest source
    row above or below, the smaller row on a tie), then a brute-force
    min-plus over each row (the smallest column on a tie)."""
    g = _check_source(source)
    dev = source.device
    src = source != 0
    rows = torch.arange(g, device=dev, dtype=torch.int64)[:, None]
    above = torch.cummax(torch.where(src, rows, -1), dim=0).values
    below = torch.flip(torch.cummin(torch.flip(
        torch.where(src, rows, 2 * g), [0]), dim=0).values, [0])
    d_above = torch.where(above >= 0, (rows - above) ** 2, NO_SOURCE)
    d_below = torch.where(below < 2 * g, (below - rows) ** 2, NO_SOURCE)
    take_above = d_above <= d_below
    g1 = torch.where(take_above, d_above, d_below)
    src_row = torch.where(take_above, above, below)
    src_row = torch.where(g1 >= NO_SOURCE, -1, src_row)
    g1 = g1.to(torch.int32)

    cols = torch.arange(g, device=dev, dtype=torch.int32)
    sq = (cols[:, None] - cols[None, :]) ** 2            # (j, c)
    best = torch.empty((g, g), dtype=torch.int32, device=dev)
    arg = torch.empty((g, g), dtype=torch.int64, device=dev)
    for r0 in range(0, g, EDT_CHUNK):
        d = g1[r0:r0 + EDT_CHUNK, None, :] + sq[None]
        best[r0:r0 + EDT_CHUNK], arg[r0:r0 + EDT_CHUNK] = torch.min(d, dim=-1)
    found = best < NO_SOURCE
    d2 = torch.where(found, best.to(torch.float32),
                     torch.full((), NO_SOURCE_DIST, dtype=torch.float32,
                                device=dev))
    dist = ieee_sqrt(d2.double()).to(torch.float32)
    ic = torch.gather(src_row, 1, arg)
    idx = torch.where(found, ic * g + arg, -1).to(torch.int32)
    return dist, idx


def edt_cuda(source: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the EDT kernels (``tde_edt``) on the current stream and count
    both launches (``edt_cuda.launches``): ``edt_columns`` writes each
    pixel's nearest source row in its column (two sweeps per column chunk,
    the one above on a tie) into an int32 scratch grid, then ``edt_rows``
    builds the exact lower envelopes of each row's 32 parts in integers,
    side by side, and takes each pixel's least value over the parts it can
    reach (binary searches), the smallest column on a tie, with its
    distance and index. Raises if a launch is refused."""
    g = _check_source(source)
    if source.device.type != "cuda":
        raise ValueError("edt_cuda takes a CUDA tensor")
    if not 0 < g <= MAX_EDT_GRID:
        raise ValueError(f"edt_cuda takes grids of 1..{MAX_EDT_GRID}, got {g}")
    src = source.to(torch.uint8).contiguous()
    dev = src.device
    src_row = torch.empty((g, g), dtype=torch.int32, device=dev)
    dist = torch.empty((g, g), dtype=torch.float32, device=dev)
    idx = torch.empty((g, g), dtype=torch.int32, device=dev)
    lib = _build.load_mapkit()
    with torch.cuda.device(dev):
        code = lib.tde_edt(g, src.data_ptr(), src_row.data_ptr(),
                           dist.data_ptr(), idx.data_ptr(),
                           torch.cuda.current_stream(dev).cuda_stream)
    if code != 0:
        raise RuntimeError("tde_edt launch failed: "
                           + lib.tde_mapkit_error_string(code).decode())
    edt_cuda.launches += 2
    return dist, idx


edt_cuda.launches = 0


def edt(source: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distance (pixels, float32) from every pixel of a square grid to the
    nearest non-zero of ``source``, and that pixel's flat index (int32);
    ``-1`` and ``sqrt(1e20)`` where the grid has no source. The kernel on a
    CUDA grid, the twin on a CPU one."""
    return (edt_cuda if source.device.type == "cuda" else edt_torch)(source)


def sdf(drivable: torch.Tensor, scale: float) -> torch.Tensor:
    """Signed distance field (meters, float32), positive inside the
    drivable area: edt(~drivable) inside minus edt(drivable) outside, in
    ``mapkit_sdf``'s float32 arithmetic."""
    drv = drivable != 0
    d_in, _ = edt((~drv).to(torch.uint8))
    d_out, _ = edt(drv.to(torch.uint8))
    zero = torch.zeros((), dtype=torch.float32, device=drv.device)
    inside = torch.where(drv, d_in, zero)
    outside = torch.where(drv, zero, d_out)
    return (inside - outside) * float(np.float32(scale))


def propagate_dir(covered: torch.Tensor, dir_angle: torch.Tensor) -> torch.Tensor:
    """``dir_angle`` of the nearest covered pixel, for every pixel (0 where
    nothing is covered)."""
    _, idx = edt((covered != 0).to(torch.uint8))
    flat = dir_angle.to(torch.float32).reshape(-1)
    out = flat[idx.clamp(min=0).long()].reshape(idx.shape)
    return torch.where(idx >= 0, out, torch.zeros((), dtype=torch.float32,
                                                  device=out.device))
