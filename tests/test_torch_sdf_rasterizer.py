"""The port's SDF-grid birdview (``ops/rasterizer.py:render_egocentric``,
the Gym adapter's renderer) against the JAX package's, un-jitted under
``vmap``, on 8 validation envs with traffic: at 64 px over 70 m (the
observation), at 128 px over 100 m, right-handed, and without the ego
highlight.

Waypoint discs, stoplines, NPC boxes and the ego box must match exactly.
The road layer is a nearest sample of the SDF grid at each pixel centre,
whose coordinates pass through cos/sin of the ego heading (an ulp apart
between XLA's CPU library and torch's on some inputs): a road pixel may
flip only where the pixel's continuous grid coordinate lies within 1e-4 of
a rounding boundary, and at most ``MAX_ROAD_FLIPS`` per case do.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env import core as jcore
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.ops import rasterizer as jras
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.maps.arrays import _pixel_coords
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.ops import rasterizer as tras

torch.set_num_threads(2)
MAX_ROAD_FLIPS = 8
CASES = {                # res, fov, left_handed, highlight_ego
    "obs 64 px / 70 m": (64, 70.0, True, True),
    "128 px / 100 m": (128, 100.0, True, True),
    "right-handed": (64, 70.0, False, True),
    "no ego highlight": (64, 70.0, True, False),
}


@pytest.fixture(scope="module")
def jassets():
    return jload("val")


@pytest.fixture(scope="module")
def tassets():
    return tload("val", device="cpu")


@pytest.fixture(scope="module")
def state(jassets):
    """8 val envs with traffic, 5 steps in (lights change, agents move)."""
    cfg = JEnvConfig()
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(8, dtype=jnp.uint32) + 100)
    st = jax.jit(jax.vmap(functools.partial(jcore.reset, cfg, jassets)))(keys)
    step = jax.jit(jax.vmap(functools.partial(jcore.step, cfg, jassets)))
    for _ in range(5):
        st = step(st, jnp.tile(jnp.array([[0.4, 0.05]]), (8, 1)))[0]
    return jax.tree.map(np.array, st)


def _inputs(st, waypoints, n_waypoints):
    t = (st.time0 + st.step_idx.astype(np.float32) * np.float32(0.1)
         ).astype(np.float32)
    return (st.town, t, st.agent_states, st.agent_attrs, st.present,
            np.asarray(waypoints)[st.case], st.target_idx,
            np.asarray(n_waypoints)[st.case])


def _render_jax(jassets, st, res, fov, left_handed, highlight_ego):
    fn = functools.partial(jras.render_egocentric, jassets.maps, res=res,
                           fov=fov, left_handed=left_handed,
                           highlight_ego=highlight_ego)
    return np.asarray(jax.vmap(fn)(*_inputs(st, jassets.suite.waypoints,
                                            jassets.suite.n_waypoints)))


def _render_torch(tassets, st, **kw):
    args = _inputs(st, tassets.suite.waypoints.numpy(),
                   tassets.suite.n_waypoints.numpy())
    return tras.render_egocentric(tassets.maps,
                                  *map(torch.from_numpy, args), **kw).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_render_egocentric_matches_jax(jassets, tassets, state, case):
    res, fov, left_handed, highlight_ego = CASES[case]
    want = _render_jax(jassets, state, res, fov, left_handed, highlight_ego)
    got = _render_torch(tassets, state, res=res, fov=fov,
                        left_handed=left_handed, highlight_ego=highlight_ego)
    assert got.shape == want.shape == (8, 3, res, res)
    assert got.dtype == np.uint8
    bad = (got != want).any(axis=1)                           # (B, res, res)
    if bad.any():
        # only road / background, and only at a rounding boundary of the grid
        road, bg = np.array(tras.COLOR_ROAD), np.array(tras.COLOR_BACKGROUND)
        for img in (got, want):
            px = img.transpose(0, 2, 3, 1)[bad]
            assert ((px == road) | (px == bg)).all(axis=-1).all(), case
        ego = torch.from_numpy(state.agent_states[:, 0])
        pts = tras.pixel_world_coords(ego, res, fov, left_handed)
        town = torch.from_numpy(state.town).long()[:, None, None]
        p = _pixel_coords(tassets.maps, town.expand(pts.shape[:-1]), pts)
        frac = (p - torch.floor(p)).numpy()[bad]
        assert (np.abs(frac - 0.5) < 1e-4).any(axis=-1).all(), case
    assert bad.sum() <= MAX_ROAD_FLIPS, f"{case}: {bad.sum()} road flips"
    colors = {tuple(c) for c in want.transpose(0, 2, 3, 1).reshape(-1, 3)}
    ego_color = tras.COLOR_EGO if highlight_ego else tras.COLOR_NPC
    for c in (tras.COLOR_ROAD, tras.COLOR_NPC, ego_color,
              tras.COLOR_WAYPOINT):
        assert tuple(int(x) for x in c) in colors, (case, c)
    assert any(tuple(int(x) for x in c) in colors for c in tras.COLOR_LIGHT)


def test_the_ego_sits_in_the_centre_heading_up(tassets):
    ego = torch.tensor([[10.0, -3.0, 0.5, 0.0]])
    pts = tras.pixel_world_coords(ego, 64, 64.0, True)
    centre = (pts[0, 31, 31] + pts[0, 32, 32]) / 2
    torch.testing.assert_close(centre, ego[0, :2])
    ahead = pts[0, 0, 31:33].mean(0) - ego[0, :2]      # row 0 is ahead
    heading = torch.atan2(ahead[1], ahead[0])
    torch.testing.assert_close(heading, ego[0, 2], atol=1e-3, rtol=0)
    assert tras.observation_shape(64) == (3, 64, 64)


def test_a_batch_renders_like_its_envs_one_by_one(tassets):
    g = torch.Generator().manual_seed(0)
    st = tcore.reset(tcore.EnvConfig(), tassets, 3, g)
    case = st.case.long()
    args = (st.town, st.time0, st.agent_states, st.agent_attrs, st.present,
            tassets.suite.waypoints[case], st.target_idx,
            tassets.suite.n_waypoints[case])
    batch = tras.render_egocentric(tassets.maps, *args, res=32, fov=50.0)
    for i in range(3):
        one = tras.render_egocentric(tassets.maps, *(a[i:i + 1] for a in args),
                                     res=32, fov=50.0)
        assert torch.equal(one[0], batch[i])
