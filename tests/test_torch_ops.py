"""The port's physics ops against the JAX package, on random inputs made
with numpy from a fixed seed; the JAX side runs un-jitted (``vmap`` over
envs where the JAX function takes one env).

Int and bool outputs must match exactly. Floats are held to atol 1e-5,
rtol 1e-5: cos, sin, tan and arctan differ by an ulp between XLA's CPU
library and torch's on a few percent of inputs, and XLA:CPU evaluates the
two-term einsums of the SAT test as a fused multiply-add.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.ops import bicycle as jb
from torchdriveenv_tpu.ops import collision as jc
from torchdriveenv_tpu.ops import offroad as jo
from torchdriveenv_tpu.ops import traffic_lights as jtl
from torchdriveenv_tpu.ops import waypoints as jw
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.ops import bicycle as tb
from torchdriveenv_tpu_torch.ops import collision as tc
from torchdriveenv_tpu_torch.ops import offroad as to
from torchdriveenv_tpu_torch.ops import traffic_lights as ttl
from torchdriveenv_tpu_torch.ops import waypoints as tw

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jassets():
    return jload("val")


@pytest.fixture(scope="module")
def tassets():
    return tload("val", device="cpu")


def _agents(rng, b, a, spread=8.0):
    """A tight cluster of boxes per env, so that many pairs overlap."""
    states = np.concatenate([
        rng.uniform(-spread, spread, size=(b, a, 2)),
        rng.uniform(-np.pi, np.pi, size=(b, a, 1)),
        rng.uniform(0.0, 10.0, size=(b, a, 1))], axis=-1).astype(np.float32)
    sizes = np.stack([rng.uniform(3.5, 5.5, size=(b, a)),
                      rng.uniform(1.6, 2.3, size=(b, a))], -1).astype(np.float32)
    present = rng.uniform(size=(b, a)) < 0.8
    present[:, 0] = True
    present[-1, 0] = False              # one env whose ego is absent
    return states, sizes, present


def _close(t, j, **kw):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(kw or TOL))


def test_bicycle_step():
    rng = np.random.default_rng(0)
    state = np.concatenate([rng.uniform(-100, 100, (64, 2)),
                            rng.uniform(-np.pi, np.pi, (64, 1)),
                            rng.uniform(0, 12, (64, 1))], -1).astype(np.float32)
    action = np.stack([rng.uniform(-1, 1, 64), rng.uniform(-0.35, 0.35, 64)],
                      -1).astype(np.float32)
    lr = rng.uniform(0.0, 1.6, 64).astype(np.float32)
    for beta in (0.5, 1.0):
        _close(tb.bicycle_step(torch.from_numpy(state), torch.from_numpy(action),
                               torch.from_numpy(lr), dt=0.1, beta_factor=beta),
               jb.bicycle_step(state, action, lr, dt=0.1, beta_factor=beta))


def test_obb_corners():
    rng = np.random.default_rng(1)
    states, sizes, _ = _agents(rng, 4, 16)
    _close(tc.obb_corners(torch.from_numpy(states), torch.from_numpy(sizes)),
           jc.obb_corners(states, sizes))


def test_collisions():
    rng = np.random.default_rng(2)
    states, sizes, present = _agents(rng, 6, 12)
    ts, tz, tp = map(torch.from_numpy, (states, sizes, present))
    pair_j = jax.vmap(jc.pairwise_collision)(states, sizes, present)
    pair_t = tc.pairwise_collision(ts, tz, tp)
    _close(pair_t, pair_j)
    np.testing.assert_array_equal(pair_t.numpy() > 0, np.asarray(pair_j) > 0)
    assert (np.asarray(pair_j) > 0).any()

    ego_j = jax.vmap(jc.ego_collision)(states, sizes, present)
    ego_t = tc.ego_collision(ts, tz, tp)
    _close(ego_t, ego_j)
    assert float(np.asarray(ego_j)[-1]) == 0.0      # absent ego never collides

    disc_j = jax.vmap(jc.ego_collision_discs)(states, sizes, present)
    _close(tc.ego_collision_discs(ts, tz, tp), disc_j)
    assert (np.asarray(disc_j) > 0).any()


def test_compute_offroad(jassets, tassets):
    rng = np.random.default_rng(3)
    b = 32
    case = rng.integers(0, 5, b)
    town = np.asarray(jassets.suite.case_town)[case].astype(np.int32)
    wp0 = np.asarray(jassets.suite.waypoints)[case, 0]
    states = np.concatenate([wp0 + rng.normal(0, 6, (b, 2)),
                             rng.uniform(-np.pi, np.pi, (b, 1)),
                             np.zeros((b, 1))], -1).astype(np.float32)
    sizes = np.tile(np.array([[4.8, 2.0]], np.float32), (b, 1))
    got = to.compute_offroad(tassets.maps, torch.from_numpy(town),
                             torch.from_numpy(states), torch.from_numpy(sizes))
    want = jax.vmap(functools.partial(jo.compute_offroad, jassets.maps))(
        town, states, sizes)
    _close(got, want)
    np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)
    assert 0 < (np.asarray(want) > 0).sum() < b


def test_light_states_at(jassets, tassets):
    rng = np.random.default_rng(4)
    town = rng.integers(0, 5, 64).astype(np.int32)
    t = rng.uniform(-50.0, 500.0, 64).astype(np.float32)
    got = ttl.light_states_at(tassets.maps, torch.from_numpy(town),
                              torch.from_numpy(t))
    want = jax.vmap(functools.partial(jtl.light_states_at, jassets.maps))(town, t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(np.asarray(want))) == 3


def test_traffic_light_violation(jassets, tassets):
    """Agents placed across stoplines so that crossings and reds occur."""
    rng = np.random.default_rng(5)
    maps = jassets.maps
    mask = np.asarray(maps.light_mask)
    pairs = np.argwhere(mask)
    sel = pairs[rng.integers(0, len(pairs), 64)]
    town, light = sel[:, 0].astype(np.int32), sel[:, 1]
    p0 = np.asarray(maps.stop_p0)[town, light]
    p1 = np.asarray(maps.stop_p1)[town, light]
    d_ang = np.asarray(maps.stop_dir)[town, light]
    d = np.stack([np.cos(d_ang), np.sin(d_ang)], -1)
    mid = (p0 + p1) / 2
    size = np.stack([rng.uniform(4.2, 5.2, 64), rng.uniform(1.8, 2.1, 64)], -1)
    # front bumper from 0.05..1 m behind the line to -0.6..1.2 m past it
    half_len = size[:, :1] / 2
    behind = rng.uniform(0.05, 1.0, (64, 1))
    ahead = rng.uniform(-0.6, 1.2, (64, 1))
    psi = (d_ang + rng.normal(0, 0.5, 64))[:, None]
    speed = np.full((64, 1), 5.0)
    prev = np.concatenate([mid - d * (half_len + behind), psi, speed], -1)
    new = np.concatenate([mid + d * (ahead - half_len), psi, speed], -1)
    t = rng.uniform(0.0, 200.0, 64)
    args = [a.astype(np.float32) for a in (t, prev, new, size)]
    got = ttl.traffic_light_violation(
        tassets.maps, torch.from_numpy(town), *map(torch.from_numpy, args))
    want = jax.vmap(functools.partial(jtl.traffic_light_violation, maps))(
        town, *args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.asarray(want).sum() < 64


def test_waypoint_reached():
    rng = np.random.default_rng(6)
    b, w = 64, 20
    wps = rng.uniform(-50, 50, (b, w, 2)).astype(np.float32)
    target = rng.integers(-1, w + 2, b).astype(np.int32)
    n_wp = rng.integers(2, w + 1, b).astype(np.int32)
    near = wps[np.arange(b), np.clip(target, 0, w - 1)]
    ego = (near + rng.normal(0, 2.5, (b, 2))).astype(np.float32)
    got = tw.waypoint_reached(*map(torch.from_numpy, (ego, wps, target, n_wp)))
    want = jax.vmap(jw.waypoint_reached)(ego, wps, target, n_wp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < np.asarray(want).sum() < b
