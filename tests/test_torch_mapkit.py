"""The map compiler's grid passes (``maps/mapkit.py``) on the CPU, where the
dispatchers run the kernels' plain twins, against scipy and the JAX
package's numpy corridor stamp.

  - ``edt_torch`` against ``scipy.ndimage.distance_transform_edt``:
    distances equal in float32 (both are the correctly rounded square root
    of the same integer), and every index points at a source at exactly
    that distance; the empty grid (index -1, distance sqrt(1e20)) and one
    pixel.
  - ``sdf`` against scipy's inside - outside: bit-equal in float32.
  - ``propagate_dir`` against scipy's nearest-source gather: at least 0.98
    agreement (equidistant ties may pick another source), and every value
    comes from a covered pixel.
  - ``stamp_segments`` against ``torchdriveenv_tpu.maps.compile
    .stamp_segment`` (numpy, float64): ``drivable`` equal and an angle
    mismatch share below 5e-3 (float32 against float64 distances flip
    equidistant pixels; the bound of ``tests/test_native.py``), on random
    segments and on edge cases: zero-length segments, segments wholly or
    partly outside the grid at negative coordinates, a one-pixel grid.
No test builds or needs the JAX package's native library or a card.
"""

import math

import numpy as np
import pytest
import torch
from scipy import ndimage

from torchdriveenv_tpu.maps.compile import stamp_segment
from torchdriveenv_tpu_torch.maps import mapkit

torch.set_num_threads(2)


def _random_binary(g, p, seed):
    rng = np.random.RandomState(seed)
    return (rng.rand(g, g) < p).astype(np.uint8)


@pytest.mark.parametrize("p,seed", [(0.01, 0), (0.2, 1), (0.9, 2)])
def test_edt_matches_scipy(p, seed):
    src = _random_binary(96, p, seed)
    dist, idx = mapkit.edt(torch.from_numpy(src))
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    dist, idx = dist.numpy(), idx.numpy()
    # scipy: the distance to the nearest ZERO of its input
    ref = ndimage.distance_transform_edt(1 - src).astype(np.float32)
    np.testing.assert_array_equal(dist, ref)
    ii, jj = np.divmod(idx.ravel(), src.shape[1])
    assert (idx >= 0).all() and src[ii, jj].all()
    gi, gj = np.meshgrid(np.arange(96), np.arange(96), indexing="ij")
    claim = np.hypot(gi.ravel() - ii, gj.ravel() - jj).astype(np.float32)
    np.testing.assert_array_equal(claim.reshape(dist.shape), dist)


def test_edt_ties_take_the_smallest_row_then_column():
    src = np.zeros((9, 9), np.uint8)
    src[2, 4] = src[6, 4] = 1           # (4, 4) is 2 from both: row 2 wins
    src[4, 0] = src[4, 8] = 1           # (4, 4) is 4 from these
    _, idx = mapkit.edt(torch.from_numpy(src))
    assert int(idx[4, 4]) == 2 * 9 + 4
    src = np.zeros((9, 9), np.uint8)
    src[4, 1] = src[4, 7] = 1           # (4, 4) is 3 from both: column 1
    _, idx = mapkit.edt(torch.from_numpy(src))
    assert int(idx[4, 4]) == 4 * 9 + 1


def test_edt_empty_grid():
    dist, idx = mapkit.edt(torch.zeros((32, 32), dtype=torch.uint8))
    assert (idx == -1).all()
    assert (dist == np.sqrt(np.float32(1e20))).all() and (dist > 1e9).all()


@pytest.mark.parametrize("g", [1, 64])
def test_edt_single_pixel(g):
    src = torch.zeros((g, g), dtype=torch.uint8)
    r, c = (0, 0) if g == 1 else (10, 50)
    src[r, c] = 1
    dist, idx = mapkit.edt(src)
    assert float(dist[r, c]) == 0.0 and int(idx[r, c]) == r * g + c
    assert (idx == r * g + c).all()
    assert float(dist[0, g - 1]) == np.float32(math.hypot(r, g - 1 - c))


def test_edt_all_source():
    dist, idx = mapkit.edt(torch.ones((17, 17), dtype=torch.uint8))
    assert (dist == 0).all()
    assert torch.equal(idx.reshape(-1), torch.arange(17 * 17, dtype=torch.int32))


def test_sdf_matches_scipy():
    drv = _random_binary(128, 0.4, 3)
    drv = ndimage.binary_closing(drv, iterations=2).astype(np.uint8)
    out = mapkit.sdf(torch.from_numpy(drv), 0.5)
    inside = ndimage.distance_transform_edt(drv) * 0.5
    outside = ndimage.distance_transform_edt(1 - drv) * 0.5
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(),
                                  (inside - outside).astype(np.float32))


def test_propagate_dir_matches_scipy():
    rng = np.random.RandomState(5)
    covered = _random_binary(96, 0.05, 6)
    ang = rng.uniform(-np.pi, np.pi, (96, 96)).astype(np.float32)
    out = mapkit.propagate_dir(torch.from_numpy(covered),
                               torch.from_numpy(ang)).numpy()
    _, idx = ndimage.distance_transform_edt(1 - covered, return_indices=True)
    ref = ang[idx[0], idx[1]]
    assert np.isclose(out, ref, atol=1e-6).mean() > 0.98
    assert np.isin(out.ravel(), ang[covered.astype(bool)].ravel()).all()
    # nothing covered: zeros
    none = mapkit.propagate_dir(torch.zeros((8, 8), dtype=torch.uint8),
                                torch.from_numpy(ang[:8, :8]))
    assert (none == 0).all()


def test_ieee_sqrt_is_correctly_rounded():
    """The twins' square root equals C's (``math.sqrt``), which torch's CPU
    ``sqrt`` does not always."""
    x = np.random.default_rng(0).uniform(0, 1e6, 20000)
    got = mapkit.ieee_sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, [math.sqrt(v) for v in x])


def _stamp_both(g, origin, scale, p0, p1, hw):
    drv = torch.zeros((g, g), dtype=torch.uint8)
    best = torch.full((g, g), 1e9, dtype=torch.float32)
    ang = torch.zeros((g, g), dtype=torch.float32)
    mapkit.stamp_segments(g, origin, scale, p0, p1, hw, drv, best, ang)
    drv_p = np.zeros((g, g), bool)
    bd_p = np.full((g, g), 1e9, np.float64)
    ang_p = np.zeros((g, g), np.float64)
    for k in range(len(hw)):
        stamp_segment(drv_p, bd_p, ang_p, p0[k], p1[k], hw[k], origin, scale)
    return (drv.numpy(), best.numpy(), ang.numpy()), (drv_p, bd_p, ang_p)


def _assert_stamps_agree(port, ref):
    (drv, best, ang), (drv_p, bd_p, ang_p) = port, ref
    np.testing.assert_array_equal(drv.astype(bool), drv_p)
    covered = bd_p < 1e8
    np.testing.assert_array_equal(best < 1e8, covered)
    mism = covered & ~np.isclose(ang, ang_p, atol=1e-5)
    assert mism.mean() < 5e-3


def _random_segments(n, seed):
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(-25, 45, (n, 2))
    p1 = p0 + rng.uniform(-20, 20, (n, 2))
    hw = rng.uniform(1.5, 4.0, (n,))
    return p0, p1, hw


@pytest.mark.parametrize("seed", [4, 7])
def test_stamp_matches_numpy_stamp(seed):
    p0, p1, hw = _random_segments(25, seed)
    port, ref = _stamp_both(160, np.array([-30.0, -30.0]), 0.5, p0, p1, hw)
    assert ref[0].any() and (ref[1] < 1e8).any()
    _assert_stamps_agree(port, ref)


def test_stamp_edge_cases():
    """Zero-length segments (drivable discs, no direction), segments wholly
    and partly outside the grid at negative coordinates, overlapping
    segments whose order decides the ties."""
    p0 = np.array([[5.0, 5.0], [-80.0, -70.0], [-40.0, 2.0], [10.0, -45.0],
                   [2.0, 2.0], [2.0, 2.0], [30.0, 30.0], [-31.0, -29.0]])
    p1 = np.array([[5.0, 5.0], [-60.0, -75.0], [12.0, 2.0], [10.0, 20.0],
                   [20.0, 2.0], [20.0, 2.0], [30.0, 30.0], [-31.0, -29.0]])
    hw = np.array([3.0, 4.0, 2.5, 3.5, 2.0, 2.0, 1.0, 2.0])
    port, ref = _stamp_both(96, np.array([-30.0, -30.0]), 0.5, p0, p1, hw)
    drv, best, _ = port
    assert drv[int((5.0 + 30.0) / 0.5), int((5.0 + 30.0) / 0.5)] == 1
    _assert_stamps_agree(port, ref)
    # the wholly outside segment changed nothing: compare without it
    keep = np.arange(len(hw)) != 1
    alone, _ = _stamp_both(96, np.array([-30.0, -30.0]), 0.5, p0[keep],
                           p1[keep], hw[keep])
    for a, b in zip(port, alone):
        np.testing.assert_array_equal(a, b)


def test_stamp_one_pixel_grid():
    p0 = np.array([[0.1, 0.1], [5.0, 5.0]])
    p1 = np.array([[0.4, 0.2], [6.0, 5.0]])
    port, ref = _stamp_both(1, np.array([0.0, 0.0]), 0.5, p0, p1,
                            np.array([0.5, 0.5]))
    _assert_stamps_agree(port, ref)
    assert port[0][0, 0] == 1


def test_segment_table_windows():
    """The windows are mapkit.cpp's: C truncation of (lo - origin) / scale,
    one pixel of margin below and two above, clamped to the grid; the origin
    enters as float32."""
    geom, win, ang, ox, oy, sc = mapkit.segment_table(
        100, np.array([-30.1, -30.0]), 0.5, np.array([[0.0, 0.0]]),
        np.array([[3.0, 4.0]]), np.array([1.0]))
    assert ox == float(np.float32(-30.1)) and sc == 0.5
    assert tuple(win[0]) == (int((-1.0 - ox) / 0.5) - 1,
                             int((-1.0 - oy) / 0.5) - 1,
                             int((4.0 - ox) / 0.5) + 2,
                             int((5.0 - oy) / 0.5) + 2, 1)
    np.testing.assert_array_equal(geom[0], [0.0, 0.0, 3.0, 4.0, 25.0, 1.0])
    assert ang[0] == np.float32(math.atan2(4.0, 3.0))


def test_cuda_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the dispatchers take the twins; the kernels' wrappers
    raise instead of falling back, and count nothing."""
    before = (mapkit.stamp_segments_cuda.launches, mapkit.edt_cuda.launches)
    with pytest.raises(ValueError):
        mapkit.edt_cuda(torch.zeros((4, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        mapkit.stamp_segments_cuda(
            4, np.zeros(2), 0.5, np.zeros((1, 2)), np.ones((1, 2)),
            np.ones(1), torch.zeros((4, 4), dtype=torch.uint8),
            torch.full((4, 4), 1e9), torch.zeros((4, 4)))
    assert (mapkit.stamp_segments_cuda.launches,
            mapkit.edt_cuda.launches) == before
