"""The port's IDM route-follower against the JAX package, on states of a
JAX traffic reset of the train suite (4 envs x 96 agents) plus 12 JAX
steps. The JAX controller runs un-jitted under ``vmap``.

Which gaps are finite must match exactly. Finite gaps and actions are held
to 1e-5: the relative positions are projected on cos/sin of each heading,
and those differ by an ulp between XLA's CPU library and torch's on a few
percent of inputs (XLA:CPU also evaluates the einsum projections as fused
multiply-adds).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env.batched import make_env_fns as jmake_env_fns
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.npc import route_follow as jrf
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.npc import route_follow as trf

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def jassets():
    return jload("train")


@pytest.fixture(scope="module")
def tassets():
    return tload("train", device="cpu")


@pytest.fixture(scope="module")
def state(jassets):
    reset_fn, step_fn = jmake_env_fns(JEnvConfig(), jassets, render=False)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4, dtype=jnp.uint32) + 11)
    st, _ = jax.jit(reset_fn)(keys)
    step = jax.jit(step_fn)
    actions = jnp.tile(jnp.array([[0.3, 0.0]]), (4, 1))
    for _ in range(12):
        st = step(st, actions).state
    return jax.tree.map(np.array, st)


def _t(st):
    return (st.time0 + st.step_idx.astype(np.float32) * np.float32(0.1)
            ).astype(np.float32)


def _gaps_close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)
    return fin


def test_leader_gaps(state):
    jg, jv = jax.vmap(jrf.leader_gaps)(state.agent_states, state.agent_attrs,
                                       state.present)
    tg, tv = trf.leader_gaps(*map(torch.from_numpy, (
        state.agent_states, state.agent_attrs, state.present)))
    fin = _gaps_close(tg, jg)
    assert fin.sum() > 20, "the traffic scene has leaders"
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)


def test_light_gaps(jassets, tassets, state):
    t = _t(state)
    jg = jax.vmap(functools.partial(jrf.light_gaps, jassets.maps))(
        state.town, t, state.agent_states, state.agent_attrs)
    tg = trf.light_gaps(tassets.maps, *map(torch.from_numpy, (
        state.town, t, state.agent_states, state.agent_attrs)))
    _gaps_close(tg, jg)


def test_npc_actions(jassets, tassets, state):
    t = _t(state)
    args = (state.town, t, state.agent_states, state.agent_attrs,
            state.present, state.npc_target_speed)
    want = jax.vmap(functools.partial(jrf.npc_actions, jassets.maps))(*args)
    got = trf.npc_actions(tassets.maps, *map(torch.from_numpy, args))
    assert got.shape == (4, 96, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _gap_args(tassets, state):
    return (tassets.maps, *map(torch.from_numpy, (
        state.town, _t(state), state.agent_states, state.agent_attrs,
        state.present)))


def test_nearest_obstacles_takes_the_twins_on_the_cpu(tassets, state):
    """On CPU tensors nearest_obstacles returns the plain leader_gaps and
    light_gaps, launches no kernel, and the scene has finite gaps of both
    kinds."""
    maps, town, t, st, at, pr = _gap_args(tassets, state)
    before = trf.npc_gaps_cuda.launches
    got = trf.nearest_obstacles(maps, town, t, st, at, pr)
    want = (*trf.leader_gaps(st, at, pr), trf.light_gaps(maps, town, t, st, at))
    assert trf.npc_gaps_cuda.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.isfinite(got[0]).any() and torch.isfinite(got[2]).any()


def test_npc_gaps_cuda_refuses_cpu_tensors(tassets, state):
    maps, town, t, st, at, pr = _gap_args(tassets, state)
    red = torch.ones((town.shape[0], maps.stop_dir.shape[1]), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        trf.npc_gaps_cuda(maps, town, red, st, at, pr)
