"""The design of the map compiler's two CUDA kernels (``csrc/mapkit.cu``),
checked on the CPU against the plain twins of ``maps/mapkit.py``.

  - The stamp kernel's tile predicate, ``mapkit.stamp_tile_hits_torch``:
    exact (a tile lists a segment iff some pixel of the tile lies in the
    segment's clamped window), its lists kept in input order by the
    kernel's compaction (chunks of 256 segments, eight warps, a ballot and
    a prefix count per warp, modelled here), and stamping each tile with
    only its list, through the twin's double arithmetic, equals
    ``stamp_segments_torch`` on the whole grid, bit for bit.
  - A model of the EDT kernel's two passes, written here with the kernel's
    integer comparisons (the column chunks' sweeps; per row, 32 parts'
    envelopes with int64 cross-multiplied breakpoints, pop on <=, the
    strict fill as each survivor's integer breakpoint floor(z) + 1;
    each thread's search of the parts from its previous winner, pruned by
    distance and least g1, ties to the smaller column), equal to
    ``edt_torch`` in distance and index on tie grids, random grids and odd
    sizes. These are the only CPU check of the tie rule the kernel keeps.
No test builds a kernel, needs a card or the JAX package's native library.
"""

import math

import numpy as np
import pytest
import torch

from torchdriveenv_tpu_torch.maps import mapkit

torch.set_num_threads(2)

TILE = mapkit.STAMP_TILE
CHUNK = TILE * TILE        # the kernel's segments per round (one a thread)
LANES = 32                 # a warp
BAND_PARTS = 64            # edt_columns' row chunks per column
ROW_PARTS = 32             # edt_rows' envelopes a row (a lane each)
ROW_THREADS = 256          # edt_rows' block
FAR = 2 ** 31 - 1          # edt_columns' "no source below"


# ---------------------------------------------------------------------------
# stamp: the tile predicate and the per-tile lists
# ---------------------------------------------------------------------------


def _grids(g):
    return (torch.zeros((g, g), dtype=torch.uint8),
            torch.full((g, g), 1e9, dtype=torch.float32),
            torch.zeros((g, g), dtype=torch.float32))


def _kernel_lists(hits: torch.Tensor):
    """A tile's list as the kernel compacts it: per chunk of 256, warp w's
    hits at (hits of warps below w) + (hits of lanes below in w)."""
    n = hits.shape[-1]
    lists = {}
    for ti in range(hits.shape[0]):
        for tj in range(hits.shape[1]):
            out = []
            for base in range(0, n, CHUNK):
                h = hits[ti, tj, base:base + CHUNK].tolist()
                h += [False] * (CHUNK - len(h))
                masks = [sum(1 << l for l in range(LANES) if h[w * LANES + l])
                         for w in range(CHUNK // LANES)]
                counts = [bin(m).count("1") for m in masks]
                slots = [None] * sum(counts)
                for tid in range(CHUNK):
                    w, lane = divmod(tid, LANES)
                    if h[tid]:
                        pos = (sum(counts[:w])
                               + bin(masks[w] & ((1 << lane) - 1)).count("1"))
                        assert slots[pos] is None
                        slots[pos] = base + tid
                out += slots
            lists[ti, tj] = out
    return lists


def _stamp_by_tiles(g, origin, scale, p0, p1, hw):
    """Each tile stamped with only its list, in list order, with the twin's
    per-segment double arithmetic restricted to the tile's pixels."""
    geom, win, ang, ox, oy, sc = mapkit.segment_table(g, origin, scale, p0,
                                                      p1, hw)
    drivable, best_d, dir_angle = grids = _grids(g)
    for (ti, tj), segs in _kernel_lists(
            mapkit.stamp_tile_hits_torch(g, win)).items():
        for s in segs:
            w0, w1, w2, w3, has_dir = (int(v) for v in win[s])
            i0, i1 = max(w0, ti * TILE), min(w2, ti * TILE + TILE, g)
            j0, j1 = max(w1, tj * TILE), min(w3, tj * TILE + TILE, g)
            assert i0 < i1 and j0 < j1           # a hit is never empty
            ax, ay, sx, sy, len2, hw2 = (float(v) for v in geom[s])
            ii = torch.arange(i0, i1, dtype=torch.float64)
            jj = torch.arange(j0, j1, dtype=torch.float64)
            px = ((ox + (ii + 0.5) * sc) - ax)[:, None]
            py = ((oy + (jj + 0.5) * sc) - ay)[None, :]
            if has_dir:
                t = torch.clamp((px * sx + py * sy) / len2, 0.0, 1.0)
            else:
                t = torch.zeros((), dtype=torch.float64)
            dx, dy = px - t * sx, py - t * sy
            d2 = dx * dx + dy * dy
            drivable[i0:i1, j0:j1][d2 <= hw2] = 1
            if has_dir:
                d = mapkit.ieee_sqrt(d2).to(torch.float32)
                best = best_d[i0:i1, j0:j1]
                closer = d < best
                best[closer] = d[closer]
                dir_angle[i0:i1, j0:j1][closer] = float(ang[s])
    return grids


def _random_case(seed):
    rng = np.random.default_rng(seed)
    n = 120
    p0 = rng.uniform(-45.0, 40.0, (n, 2))
    p1 = p0 + rng.uniform(-12.0, 12.0, (n, 2))
    hw = rng.uniform(0.5, 4.0, n)
    p1[::9] = p0[::9]                                  # zero length
    return 96, np.array([-30.0, -30.0]), p0, p1, hw


def _wide_case():
    rng = np.random.default_rng(3)
    n = 50
    p0 = rng.uniform(-20.0, 520.0, (n, 2))
    p1 = p0 + rng.uniform(-25.0, 25.0, (n, 2))
    return 1000, np.array([-10.0, -10.0]), p0, p1, rng.uniform(1.0, 5.0, n)


def _one_tile_case():
    """700 segments (three chunks) through one tile: order decides."""
    return (48, np.array([-30.0, -30.0]), *mapkit.one_tile_segments(700))


def _border_case():
    """Windows whose edges fall on the borders of the grid's six tiles."""
    rng = np.random.default_rng(8)
    return (96, np.array([0.0, 0.0]),
            *mapkit.tile_border_segments(rng, 80, 96 // TILE))


STAMP_CASES = {
    "random seed 1": lambda: _random_case(1),
    "random seed 2": lambda: _random_case(2),
    "1000 x 1000 grid": _wide_case,
    "700 segments through one tile": _one_tile_case,
    "windows on tile borders": _border_case,
    "no segments": lambda: (64, np.array([-30.0, -30.0]), np.zeros((0, 2)),
                            np.zeros((0, 2)), np.zeros(0)),
    "one-pixel grid": lambda: (1, np.array([0.0, 0.0]),
                               np.array([[0.1, 0.1], [5.0, 5.0]]),
                               np.array([[0.4, 0.2], [6.0, 5.0]]),
                               np.array([0.5, 0.5])),
}


@pytest.mark.parametrize("case", list(STAMP_CASES))
def test_tile_hits_are_exact_and_in_input_order(case):
    g, origin, p0, p1, hw = STAMP_CASES[case]()
    win = mapkit.segment_table(g, origin, 0.5, p0, p1, hw)[1]
    hits = mapkit.stamp_tile_hits_torch(g, win)
    tiles = -(-g // TILE)
    assert hits.shape == (tiles, tiles, len(hw)) and hits.dtype == torch.bool
    # exact: some pixel of the tile (inside the grid) lies in the window
    pad = tiles * TILE
    for s in range(len(hw)):
        i0, j0, i1, j1 = (int(v) for v in win[s, :4])
        inside = torch.zeros((pad, pad), dtype=torch.bool)
        if i0 < i1 and j0 < j1:
            inside[i0:i1, j0:j1] = True
        inside[g:], inside[:, g:] = False, False
        want = inside.reshape(tiles, TILE, tiles, TILE).any(3).any(1)
        assert torch.equal(hits[:, :, s], want), f"segment {s} {win[s]}"
    # the kernel's compaction keeps input order
    for (ti, tj), segs in _kernel_lists(hits).items():
        assert segs == torch.nonzero(hits[ti, tj]).flatten().tolist()
    if case == "windows on tile borders":                 # the case is real
        assert ((win[:, 2:4] % TILE == 0) & (win[:, 2:4] < g)).sum() > 40
    if case == "700 segments through one tile":
        per_tile = hits.sum(-1)
        assert int(per_tile.max()) > 2 * CHUNK         # lists span chunks


@pytest.mark.parametrize("case", list(STAMP_CASES))
def test_stamp_from_tile_lists_equals_twin(case):
    g, origin, p0, p1, hw = STAMP_CASES[case]()
    got = _stamp_by_tiles(g, origin, 0.5, p0, p1, hw)
    want = _grids(g)
    mapkit.stamp_segments_torch(g, origin, 0.5, p0, p1, hw, *want)
    for name, a, b in zip(("drivable", "dir_best_d", "dir_angle"), got, want):
        assert torch.equal(a, b), (
            f"{name} differs at {int((a != b).sum())} pixels")
    if case == "700 segments through one tile":
        # both directions win somewhere: order and position decide
        assert want[2][want[1] < 1e8].unique().numel() >= 2


# ---------------------------------------------------------------------------
# EDT: a model of the kernel's two passes
# ---------------------------------------------------------------------------


def _model_columns(src: np.ndarray) -> np.ndarray:
    """edt_columns: per column, 32 chunks of rows; each chunk's first and
    last source, the nearest outside it from the other chunks, then a sweep
    up (nearest at or below) and a sweep down (the nearer, above on a tie).
    Returns each pixel's source row or -1."""
    g = src.shape[0]
    rows = -(-g // BAND_PARTS)
    out = np.empty((g, g), np.int64)
    for j in range(g):
        col = src[:, j] != 0
        parts = [(min(y * rows, g), min(min(y * rows, g) + rows, g))
                 for y in range(BAND_PARTS)]
        first, last = [], []
        for r0, r1 in parts:
            hit = [r for r in range(r0, r1) if col[r]]
            first.append(hit[0] if hit else FAR)
            last.append(hit[-1] if hit else -1)
        for y, (r0, r1) in enumerate(parts):
            above = max(last[:y], default=-1)
            below = min(first[y + 1:], default=FAR)
            for r in range(r1 - 1, r0 - 1, -1):
                if col[r]:
                    below = r
                out[r, j] = below
            for r in range(r0, r1):
                b = int(out[r, j])
                if b == r:
                    above = r
                d_above = (r - above) ** 2 if above >= 0 else mapkit.NO_SOURCE
                d_below = (b - r) ** 2 if b != FAR else mapkit.NO_SOURCE
                d = min(d_above, d_below)
                out[r, j] = (-1 if d >= mapkit.NO_SOURCE
                             else (above if d_above <= d_below else b))
    return out


def _c_div_floor(num: int, den: int) -> int:
    """The kernel's floor division: C's truncation, then one down for a
    negative remainder (den > 0)."""
    q = abs(num) // den * (1 if num >= 0 else -1)
    if num % den != 0 and num < 0:
        q -= 1
    assert q == num // den
    return q


def _model_part(i: int, s: np.ndarray, c0: int, c1: int, g: int):
    """One lane's envelope of columns [c0, c1) of row i, then each entry's
    first j: (columns, F, first j of each, least g1)."""
    v, f = [], []
    vt = ft = vp = fp = 0
    zn, zd, mg = 0, 1, None
    for q in range(c0, c1):
        if s[q] < 0:
            continue
        g1 = (i - int(s[q])) ** 2
        fq = g1 + q * q
        assert fq < 2 ** 31
        mg = g1 if mg is None else min(mg, g1)
        while len(v) >= 2:
            lhs, rhs = (fq - ft) * zd, zn * (2 * (q - vt))
            assert max(abs(lhs), abs(rhs)) < 2 ** 42
            if lhs > rhs:
                break
            v.pop(), f.pop()
            vt, ft = vp, fp
            if len(v) >= 2:
                vp, fp = v[-2], f[-2]
                zn, zd = ft - fp, 2 * (vt - vp)
        if v:
            vp, fp = vt, ft
            zn, zd = fq - ft, 2 * (q - vt)
        v.append(q), f.append(fq)
        vt, ft = q, fq
    t = [0] + [min(max(_c_div_floor(f[k] - f[k - 1], 2 * (v[k] - v[k - 1]))
                       + 1, 0), g) for k in range(1, len(v))]
    assert t == sorted(t)
    return v, f, t, mg


def _model_row(i: int, s: np.ndarray):
    """edt_rows for row i with source rows s: the 32 parts' envelopes, then
    each thread's pixels searched as the kernel does. Returns (the winning
    column and its squared distance per j) or None without a source."""
    g = s.shape[0]
    span = -(-g // ROW_PARTS)
    parts = [_model_part(i, s, min(p * span, g), min(p * span + span, g), g)
             for p in range(ROW_PARTS)]
    if not any(part[0] for part in parts):
        return None
    out = [None] * g
    for tid in range(ROW_THREADS):
        lowest = 0
        for j in range(tid, g, ROW_THREADS):
            best, bv = 2 ** 31 - 1, 2 ** 31 - 1
            start = max(j // span, lowest)
            for step, order in ((1, range(start, ROW_PARTS)),
                                (-1, range(start - 1, lowest - 1, -1))):
                for p in order:
                    edge = (max(p * span - j, 0) if step > 0
                            else j - ((p + 1) * span - 1))
                    if p != start and (edge * edge >= best if step > 0
                                       else edge * edge > best):
                        break
                    v, f, t, mg = parts[p]
                    if not v or edge * edge + mg > best:
                        continue
                    x, y = 0, len(v)
                    while y - x > 1:
                        mid = (x + y) >> 1
                        if t[mid] <= j:
                            x = mid
                        else:
                            y = mid
                    c = v[x]
                    d = (j - c) ** 2 + f[x] - c * c
                    if d < best or (d == best and c < bv):
                        best, bv = d, c
            lowest = bv // span
            out[j] = (bv, best)
    return out


def edt_model(source: np.ndarray):
    g = source.shape[0]
    src_row = _model_columns(source)
    dist = np.empty((g, g), np.float32)
    idx = np.empty((g, g), np.int32)
    far = np.float32(math.sqrt(np.float64(np.float32(mapkit.NO_SOURCE_DIST))))
    for i in range(g):
        win = _model_row(i, src_row[i])
        if win is None:
            dist[i], idx[i] = far, -1
            continue
        for j, (v, d2) in enumerate(win):
            sr = int(src_row[i, v])
            assert d2 == (j - v) ** 2 + (i - sr) ** 2
            dist[i, j] = np.float32(math.sqrt(np.float64(np.float32(d2))))
            idx[i, j] = sr * g + v
    return dist, idx


def _tie_grid(name, g=96):
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    return {
        "checkerboard": (ii + jj) % 2 == 0,
        "stripes: every 3rd column and every 2nd row": (jj % 3 == 0)
        | ((ii % 2 == 0) & (jj > g // 2)),
        "diagonal": ii == jj,
        "two equidistant sources": ((ii == 20) & ((jj == 10) | (jj == 70)))
        | ((jj == 47) & ((ii == 60) | (ii == 90))),
    }[name].astype(np.uint8)


def _ring_grid(g):
    """Sparse rows far from their sources: a ring and one corner pixel."""
    ii, jj = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
    ring = np.abs(np.hypot(ii - g / 2 + 0.3, jj - g / 2 - 0.3) - 0.4 * g) < 0.7
    ring[-1, -1] = True
    return ring.astype(np.uint8)


def _random_grid(g, p, seed):
    return (np.random.default_rng(seed).random((g, g)) < p).astype(np.uint8)


EDT_CASES = {
    **{name: (lambda name=name: _tie_grid(name)) for name in (
        "checkerboard", "stripes: every 3rd column and every 2nd row",
        "diagonal", "two equidistant sources")},
    "random p 0.01": lambda: _random_grid(128, 0.01, 10),
    "random p 0.3": lambda: _random_grid(128, 0.3, 11),
    "random p 0.9": lambda: _random_grid(128, 0.9, 12),
    "size 1": lambda: np.ones((1, 1), np.uint8),
    "size 2": lambda: np.array([[0, 0], [0, 1]], np.uint8),
    "size 33": lambda: _random_grid(33, 0.05, 13),
    "size 100": lambda: _random_grid(100, 0.002, 14),
    "size 300, a ring and a corner": lambda: _ring_grid(300),
}


@pytest.mark.parametrize("case", list(EDT_CASES))
def test_edt_model_of_the_kernel_equals_twin(case):
    src = EDT_CASES[case]()
    dist, idx = edt_model(src)
    want_d, want_i = mapkit.edt_torch(torch.from_numpy(src))
    np.testing.assert_array_equal(dist, want_d.numpy())
    np.testing.assert_array_equal(idx, want_i.numpy())
    if case == "checkerboard":
        # (5, 6) is 1 from four sources: the smallest column wins
        assert int(want_i[5, 6]) == 5 * 96 + 5


def test_edt_model_empty_grid():
    dist, idx = edt_model(np.zeros((40, 40), np.uint8))
    assert (idx == -1).all()
    assert (dist == np.float32(math.sqrt(np.float64(np.float32(1e20))))).all()
