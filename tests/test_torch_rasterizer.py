"""The port's rasterizer against the JAX package.

The fixture is the one of tests/test_rasterizer_pallas.py: 8 validation
envs advanced 12 steps. ``prepare_obs_inputs`` must produce JAX's blocks;
the plain twin ``render_obs_torch``, fed JAX's blocks, must produce the
images of the un-jitted JAX ``render_obs_ref`` pixel for pixel (the pixel
math is + - * / and compares only, which eager XLA and torch round alike;
cos/sin enter only through the blocks). The kernel itself runs only on a
GPU: tests/test_torch_rasterizer_cuda.py (which imports no JAX, so it runs
on a machine without it) compares it with the twin there.
tests/test_torch_rasterizer_cull.py holds the kernel's cull to the twin on
the CPU.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env.batched import make_env_fns as jmake_env_fns
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.ops import rasterizer_pallas as jrp
from torchdriveenv_tpu_torch.config import EnvConfig as TEnvConfig
from torchdriveenv_tpu_torch.env.batched import make_env_fns as tmake_env_fns
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.ops import rasterizer as tr
from torchdriveenv_tpu_torch.ops import rasterizer_cuda as trc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jassets():
    return jload("val")


@pytest.fixture(scope="module")
def tassets():
    return tload("val", device="cpu")


def fixture_states(jassets):
    """The 8-env fixture: validation envs advanced 12 steps by the JAX env
    (also the input of tests/test_torch_rasterizer_cull.py)."""
    reset_fn, step_fn = jmake_env_fns(JEnvConfig(), jassets, render=False)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(8, dtype=jnp.uint32))
    state, _ = jax.jit(reset_fn)(keys)
    actions = jnp.tile(jnp.array([[0.4, 0.05]]), (8, 1))
    step = jax.jit(step_fn)
    for _ in range(12):
        state = step(state, actions).state
    return jax.tree.map(np.array, state)


@pytest.fixture(scope="module")
def states(jassets):
    return fixture_states(jassets)


def _render_args(assets_suite, state):
    t = (state.time0 + state.step_idx.astype(np.float32) * np.float32(0.1)
         ).astype(np.float32)
    return (state.town, t, state.agent_states, state.agent_attrs,
            state.present, np.asarray(assets_suite.waypoints)[state.case],
            state.target_idx, np.asarray(assets_suite.n_waypoints)[state.case])


def fixture_prep(jassets, states):
    """The fixture's blocks, packed by JAX's own prepare_obs_inputs."""
    args = _render_args(jassets.suite, states)
    prep = jax.vmap(lambda *a: jrp.prepare_obs_inputs(jassets.maps, *a,
                                                      fov=70.0))(*args)
    return [np.array(x) for x in prep]


@pytest.fixture(scope="module")
def jax_prep(jassets, states):
    return fixture_prep(jassets, states)


def test_prepare_obs_inputs_matches_jax(tassets, jassets, states, jax_prep):
    args = [torch.from_numpy(np.array(a))
            for a in _render_args(jassets.suite, states)]
    got = [x.numpy() for x in trc.prepare_obs_inputs(tassets.maps, *args,
                                                     fov=70.0)]
    names = ("ci", "cj", "nseg", "env_block", "agent_block", "wp_block")
    got_t = trc.prepare_obs_inputs(tassets.maps, *args, fov=70.0)
    # the kernel's wrapper takes contiguous blocks only
    assert all(x.is_contiguous() for x in got_t)
    for name, g, w in zip(names, got, jax_prep):
        assert g.shape == w.shape and g.dtype == w.dtype, name
    for i in range(3):
        np.testing.assert_array_equal(got[i], jax_prep[i], err_msg=names[i])
    # the cos/sin columns carry the libraries' ulp differences; every other
    # entry is a copy, a product by 0.5 or a palette value
    trig = {"env_block": (np.s_[:, 0, 2:4],), "agent_block": (np.s_[:, :, 2:4],)}
    for i in range(3, 6):
        g, w = got[i].copy(), jax_prep[i].copy()
        for sl in trig.get(names[i], ()):
            np.testing.assert_allclose(g[sl], w[sl], atol=1e-6, rtol=0)
            g[sl] = w[sl] = 0.0
        np.testing.assert_array_equal(g, w, err_msg=names[i])
    assert (jax_prep[4][..., 6] > 0).any(), "NPCs are visible"
    assert (jax_prep[3][:, 2:6, 7] > 0).any(), "stoplines are visible"


def test_twin_pixel_exact_against_render_obs_ref(tassets, jassets, states,
                                                 jax_prep):
    town = states.town
    want = np.asarray(jax.vmap(
        lambda *a: jrp.render_obs_ref(jassets.maps, *a))(town, *jax_prep))
    got = trc.render_obs_torch(tassets.maps, torch.from_numpy(town),
                               *map(torch.from_numpy, jax_prep)).numpy()
    assert got.shape == want.shape == (8, 3, 64, 64)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_end_to_end_render_close_to_jax(tassets, jassets, states):
    """The port's own cull + twin against JAX's twin path: only pixels on
    a box edge may flip through the ulp-level cos/sin differences."""
    args = _render_args(jassets.suite, states)
    want = np.asarray(jrp.render_observation(jassets.maps, *args,
                                             backend="xla"))
    got = trc.render_observation(
        tassets.maps, *[torch.from_numpy(np.array(a)) for a in args],
        backend="torch").numpy()
    assert (got != want).any(axis=1).mean() < 1e-3


def _single_ego(tassets, jassets, n_wp, tgt):
    wp0 = np.asarray(jassets.suite.waypoints)[0, 0]
    n_pad = jassets.suite.waypoints.shape[1]
    states = np.concatenate([wp0, np.zeros(2, np.float32)])[None, None]
    wps = np.zeros((1, n_pad, 2), np.float32)
    wps[0, 0] = wp0
    wps[0, 1] = wp0 + np.array([10.0, 0.0], np.float32)
    wps[0, 2] = wp0 + np.array([20.0, 0.0], np.float32)
    img = trc.render_observation(
        tassets.maps, torch.zeros(1, dtype=torch.int32), torch.zeros(1),
        torch.from_numpy(states.astype(np.float32)),
        torch.tensor([[[4.8, 1.9, 1.4]]]), torch.ones(1, 1, dtype=torch.bool),
        torch.from_numpy(wps), torch.full((1,), tgt, dtype=torch.int32),
        torch.full((1,), n_wp, dtype=torch.int32), backend="torch")
    return img.numpy()


def _count(img, color):
    flat = img.transpose(0, 2, 3, 1).reshape(-1, 3)
    return int((flat == np.asarray(color, np.uint8)).all(-1).sum())


def test_full_waypoint_sequence_rendered(tassets, jassets):
    """Every waypoint but index 0 is drawn; the current target does not
    change the frame."""
    one = _count(_single_ego(tassets, jassets, 2, 1), tr.COLOR_WAYPOINT)
    two = _count(_single_ego(tassets, jassets, 3, 1), tr.COLOR_WAYPOINT)
    assert one > 0
    assert two > 1.5 * one, (one, two)
    np.testing.assert_array_equal(_single_ego(tassets, jassets, 3, 1),
                                  _single_ego(tassets, jassets, 3, 2))


def test_ego_only_and_empty_scene(tassets):
    """No NPCs: the frame holds road, background, ego and waypoints only."""
    reset_fn, _ = tmake_env_fns(TEnvConfig(ego_only=True), tassets)
    _, obs = reset_fn(torch.Generator().manual_seed(0), 4)
    flat = obs.numpy().transpose(0, 2, 3, 1).reshape(4, -1, 3)
    ego_c = np.asarray(tr.COLOR_EGO, np.uint8)
    npc_c = np.asarray(tr.COLOR_NPC, np.uint8)
    assert (flat == ego_c).all(-1).any(-1).all(), "ego visible"
    assert not (flat == npc_c).all(-1).any(), "no NPCs drawn"


def test_cuda_backend_refuses_cpu_tensors(tassets, jassets, states, jax_prep):
    args = [torch.from_numpy(np.array(a))
            for a in _render_args(jassets.suite, states)]
    with pytest.raises(ValueError, match="CUDA"):
        trc.render_observation(tassets.maps, *args, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        trc.render_obs_cuda(tassets.maps, torch.from_numpy(states.town),
                            *map(torch.from_numpy, jax_prep))
    with pytest.raises(ValueError, match="backend"):
        trc.render_observation(tassets.maps, *args, backend="pallas")
