"""The port's scripted demonstration driver against the JAX package's, on
states of the JAX env after 0, 20 and 60 driven steps (validation and
training suites), carried across with ``EnvState.from_numpy``.

Actions agree within 1e-5 (the projections on the ego's axes differ from
XLA's by an ulp), lie in the env's box, and the scripted policy's discrete branches
agree on every env where the action shows them: a hard brake (accel -1), a
saturated throttle (accel +1, the punch through a yellow light or a capped
cruise), a full-lock swerve or a clipped steer (|steer| 0.3).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env import batched as jbatched
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.rl import demo as jdemo
from torchdriveenv_tpu_torch.config import EnvConfig as TEnvConfig
from torchdriveenv_tpu_torch.env.core import EnvState
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.rl import demo as tdemo

torch.set_num_threads(2)
B = 24
STEPS = (0, 20, 60)


@functools.lru_cache(maxsize=None)
def _jax_states_and_actions(suite):
    """{steps: (JAX env state as numpy, the JAX scripted policy's actions)};
    the env is stepped with those actions, 20 jitted steps at a time."""
    assets = jload(suite)
    cfg = JEnvConfig()
    drv = jdemo.make_scripted_driver(cfg, assets)
    reset_fn, step_fn = jbatched.make_env_fns(cfg, assets, render=False)

    @jax.jit
    def roll(state):
        def one(s, _):
            return step_fn(s, drv(s)).state, None
        return jax.lax.scan(one, state, None, length=20)[0]

    act = jax.jit(drv)
    state, _ = reset_fn(jax.random.split(jax.random.PRNGKey(5), B))
    out = {}
    for n in range(0, max(STEPS) + 1, 20):
        if n in STEPS:
            out[n] = (jax.tree.map(np.asarray, state), np.asarray(act(state)))
        state = roll(state)
    return out


@pytest.fixture(scope="module", params=["val", "train"])
def suite(request):
    return request.param, tload(request.param, device="cpu")


@pytest.mark.parametrize("steps", STEPS)
def test_driver_matches_jax(suite, steps):
    name, tassets = suite
    jstate, want = _jax_states_and_actions(name)[steps]
    state = EnvState.from_numpy(jstate, device="cpu")
    got = tdemo.make_scripted_driver(TEnvConfig(), tassets)(state)
    assert got.shape == (B, 2) and got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.isfinite(got).all()
    assert (np.abs(got[:, 0]) <= 1.0).all() and (np.abs(got[:, 1]) <= 0.3).all()
    for col, edge in ((0, -1.0), (0, 1.0), (1, 0.3), (1, -0.3), (1, 0.0)):
        np.testing.assert_array_equal(
            got[:, col] == np.float32(edge), want[:, col] == np.float32(edge),
            err_msg=f"{name} after {steps} steps: column {col} at {edge}")


def test_the_states_exercise_the_branches():
    """Across the six batches the scripted policy brakes hard, saturates the throttle
    and clips the steer somewhere, so the comparison above reads branches."""
    acts = np.concatenate([a for s in ("val", "train")
                           for _, a in _jax_states_and_actions(s).values()])
    assert (acts[:, 0] == -1.0).any()
    assert (acts[:, 0] == 1.0).any()
    assert (np.abs(acts[:, 1]) == np.float32(0.3)).any()
    assert len(np.unique(acts[:, 0])) > 20


def test_first_argmin_ties_like_jnp():
    x = torch.tensor([[float("inf")] * 4, [3.0, 1.0, 1.0, 2.0],
                      [0.5, float("inf"), 0.5, 0.1]])
    assert tdemo._first_argmin(x).tolist() == [0, 1, 3]
    assert tdemo._first_argmin(x).tolist() == np.asarray(
        jax.numpy.argmin(jax.numpy.asarray(x.numpy()), axis=-1)).tolist()


def test_wrap_is_floor_mod():
    a = torch.tensor([-7.0, -3.2, 0.0, 3.2, 7.0, -np.pi, np.pi])
    np.testing.assert_allclose(tdemo._wrap(a).numpy(),
                               np.asarray(jdemo._wrap(a.numpy())), atol=1e-6)
    assert (tdemo._wrap(a) >= -np.pi - 1e-6).all()
    assert (tdemo._wrap(a) < np.pi).all()
