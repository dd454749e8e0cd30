"""The port's offline map compiler (``maps/compile.py``) against the JAX
package's, on the compiler's inputs rebuilt from the shipped bundles
(``suite_from_bundle``, ``background_from_bundle``: every waypoint, scenario
agent, replayed sequence and background-cache agent, at float32).

  - the host pieces equal the JAX functions exactly: ``calibrate_widths``,
    ``simplify_polyline`` (with ``return_idx``), ``seg_intersect``,
    ``town_evidence``, ``town_content``, ``synthesize_lights``, and
    ``compile_segment_index`` in all five towns (float64 torch in numpy's
    dtypes and operation order);
  - ``compile_suite`` / ``compile_background`` of the rebuilt inputs equal
    the shipped bundles;
  - ``compile_town_map`` of one town at the full 1024 x 1024 grid on the CPU
    (the kernels' twins) against the JAX function's scipy path: ``origin``
    and the float32 ``sdf`` bit-equal, a direction mismatch share of at
    most 5e-3 (scipy breaks equidistant ties its own way).
The JAX package's native library is switched off (``native.available``
patched to False) before any JAX compiler call: no test here runs g++.
"""

import os

import numpy as np
import pytest
import torch

from torchdriveenv_tpu.maps import compile as jmc
from torchdriveenv_tpu.maps import native as jnative
from torchdriveenv_tpu_torch.maps import compile as tmc

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(ROOT, "torchdriveenv_tpu", "assets")
CONSTANTS = (
    "TOWNS", "GRID", "SCALE", "MARGIN", "WAYPOINT_HALFWIDTH", "HW_MIN",
    "PASS_MARGIN", "EVIDENCE_LON_SLACK", "EVIDENCE_LAT_CAP",
    "ENDCAP_EXTENSION", "SPAWN_END_EXTENSION", "STUB_HALFWIDTH",
    "STUB_LENGTH", "MAX_AGENTS", "MAX_WAYPOINTS", "MAX_SCEN_AGENTS",
    "MAX_REPLAY_T", "MAX_BG_FILES", "MAX_LIGHTS", "MAX_SEGMENTS", "SEG_CELL",
    "SEG_GRID", "SEG_K", "SEG_REACH", "SEG_F", "LIGHT_GREEN", "LIGHT_YELLOW",
    "LIGHT_RED", "STOPLINE_SETBACK", "STOPLINE_HALFWIDTH")


def bundled(name):
    return np.load(os.path.join(ASSETS, name))


def compiler_inputs():
    """(suites, background): the compiler's inputs from the shipped
    bundles."""
    suites = {s: tmc.suite_from_bundle(bundled(f"suite_{s}_v1.npz"))
              for s in ("train", "val")}
    return suites, tmc.background_from_bundle(bundled("background_v1.npz"))


@pytest.fixture(scope="module")
def inputs():
    return compiler_inputs()


@pytest.fixture(autouse=True)
def no_native(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _assert_segments_equal(got, want):
    assert len(got) == len(want)
    for (a0, a1, ah), (b0, b1, bh) in zip(got, want):
        np.testing.assert_array_equal(a0, b0)
        np.testing.assert_array_equal(a1, b1)
        assert ah == bh


def test_constants_match_jax():
    for name in CONSTANTS:
        assert getattr(tmc, name) == getattr(jmc, name), name


def test_bundles_round_trip(inputs):
    suites, background = inputs
    assert {t: len(v) for t, v in background.items()} == {
        "Town01": 10, "Town02": 20, "Town03": 20, "Town07": 15,
        "Town10HD": 10}
    for name in ("train", "val"):
        want = bundled(f"suite_{name}_v1.npz")
        for fn in (tmc.compile_suite, jmc.compile_suite):
            got = fn(suites[name])
            for k in want.files:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    want = bundled("background_v1.npz")
    got, jgot = (tmc.compile_background(background),
                 jmc.compile_background(background))
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        np.testing.assert_array_equal(jgot[k], want[k], err_msg=k)


@pytest.mark.parametrize("town", tmc.TOWNS)
def test_town_content_matches_jax(inputs, town):
    suites, background = inputs
    ev = tmc.town_evidence(suites, background, town)
    np.testing.assert_array_equal(ev, jmc.town_evidence(suites, background,
                                                        town))
    got = tmc.town_content(suites, background, town)
    want = jmc.town_content(suites, background, town)
    _assert_segments_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    _assert_segments_equal(got[2], want[2])
    # the pieces on every route of the town
    for suite in suites.values():
        for loc, wps in zip(suite["locations"], suite["waypoint_suite"]):
            if loc != town:
                continue
            arr = np.asarray(wps, np.float64)
            np.testing.assert_array_equal(tmc.calibrate_widths(arr, ev),
                                          jmc.calibrate_widths(arr, ev))
            for eps in (0.4, 2.0):
                (tp, ti), (jp, ji) = (
                    f(arr, eps=eps, return_idx=True)
                    for f in (tmc.simplify_polyline, jmc.simplify_polyline))
                np.testing.assert_array_equal(tp, jp)
                np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tmc.simplify_polyline(arr),
                                          jmc.simplify_polyline(arr))


def test_seg_intersect_matches_jax():
    rng = np.random.default_rng(0)
    hits = 0
    for _ in range(2000):
        a0, a1, b0, b1 = rng.uniform(-10, 10, (4, 2))
        got, want = (f(a0, a1, b0, b1)
                     for f in (tmc.seg_intersect, jmc.seg_intersect))
        assert (got is None) == (want is None)
        if got is not None:
            hits += 1
            np.testing.assert_array_equal(got, want)
    assert 100 < hits < 1900
    parallel = np.array([[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 2.0]])
    assert tmc.seg_intersect(*parallel) is None


@pytest.mark.parametrize("town", tmc.TOWNS)
def test_lights_and_segment_index_match_jax(inputs, town):
    suites, background = inputs
    got, n = tmc.synthesize_lights(suites, town)
    want, jn = jmc.synthesize_lights(suites, town)
    ti = tmc.TOWNS.index(town)
    assert n == jn == int(bundled("maps_v1.npz")["light_mask"][ti].sum())
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    _, points, render = tmc.town_content(suites, background, town)
    lo, hi = points.min(0) - tmc.MARGIN, points.max(0) + tmc.MARGIN
    origin = ((lo + hi) / 2.0 - tmc.GRID * tmc.SCALE / 2.0).astype(np.float32)
    idx, k_max = tmc.compile_segment_index(render, origin, device="cpu")
    jidx, jk_max = jmc.compile_segment_index(render, origin)
    assert k_max == jk_max > 0
    for k in jidx:
        got = idx[k].numpy()
        assert got.dtype == jidx[k].dtype, k
        np.testing.assert_array_equal(got, jidx[k], err_msg=k)


def test_compile_town_map_full_grid_matches_jax(inputs):
    suites, background = inputs
    segs, points, _ = tmc.town_content(suites, background, "Town07")
    origin, sdf, dirs = tmc.compile_town_map(segs, points, device="cpu")
    jorigin, jsdf, jdirs = jmc.compile_town_map(segs, points)
    assert origin.dtype == np.float32 and sdf.shape == (tmc.GRID, tmc.GRID)
    np.testing.assert_array_equal(origin, jorigin)
    assert sdf.dtype == dirs.dtype == torch.float32
    np.testing.assert_array_equal(sdf.numpy(), jsdf)
    assert 0.02 < float((sdf > 0).float().mean()) < 0.5
    diff = np.abs((dirs.numpy() - jdirs + np.pi) % (2 * np.pi) - np.pi)
    assert float((diff > 1e-6).mean()) <= 5e-3


def test_entry_points_default_to_the_gpu(inputs):
    """``device=None`` is the GPU: without one the grid passes raise, never
    run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    suites, background = inputs
    segs, points, render = tmc.town_content(suites, background, "Town01")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmc.compile_town_map(segs, points)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmc.compile_segment_index(render, np.zeros(2, np.float32))
