"""The port's Gymnasium adapter (``env/gym_adapter.py``), registered as
``torchdriveenv-torch-v0``, on the CPU: the three user surfaces of
``tests/test_user_surfaces.py`` (a full episode, the video written at
close, deterministic seeding), and transitions against the JAX adapter's
(``torchdriveenv-v0``) from the same state.

The JAX adapter's reset draws from PRNG keys that have no torch twin, so
the port's adapter is given the JAX adapter's state after its reset
(``EnvState.from_numpy`` with a leading axis of 1); from there both step
the same actions. The JAX adapter jits its step and render, so floats are
held to the golden tolerance, flags exactly, and the observations may
differ only by road pixels at a rounding boundary of the SDF grid (see
``tests/test_torch_sdf_rasterizer.py``): at most ``MAX_ROAD_FLIPS``.
"""

import os

import gymnasium as gym
import jax
import numpy as np
import pytest
import torch

import torchdriveenv_tpu  # noqa: F401  (registers torchdriveenv-v0)
import torchdriveenv_tpu_torch  # noqa: F401  (registers torchdriveenv-torch-v0)
from torchdriveenv_tpu import config as jc
from torchdriveenv_tpu_torch import config as tc
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.env.gym_adapter import TorchGymEnv
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.ops.rasterizer import COLOR_BACKGROUND, COLOR_ROAD

torch.set_num_threads(2)
INFO_KEYS = {"offroad", "collision", "traffic_light_violation", "is_success",
             "reached_waypoint_num", "psi_smoothness", "speed_smoothness"}
GOLDEN_TOL = dict(atol=1e-4, rtol=1e-5)
MAX_ROAD_FLIPS = 8


@pytest.fixture(scope="module")
def tassets():
    return tload("val", device="cpu")


def _small_env_cfg(pkg=tc, **kw):
    """``test_user_surfaces.py``'s config: 16-step episodes."""
    return pkg.EnvConfig(
        max_environment_steps=16, seed=11, reset_pool=0,
        simulator=pkg.TorchDriveConfig(renderer=pkg.RendererConfig(obs_res=64)),
        **kw)


def _make(tassets, **kw):
    return gym.make("torchdriveenv-torch-v0",
                    args={"cfg": _small_env_cfg(**kw), "data": tassets,
                          "device": "cpu"})


def test_gym_make_full_episode(tassets):
    env = _make(tassets)
    assert isinstance(env.unwrapped, TorchGymEnv)
    obs, info = env.reset(seed=5)
    assert obs.shape == (3, 64, 64) and obs.dtype == np.uint8
    assert env.action_space.shape == (2,)
    steps, done = 0, False
    while not done:
        obs, r, term, trunc, info = env.step(np.array([0.5, 0.0], np.float32))
        assert isinstance(r, float) and isinstance(term, bool)
        steps += 1
        done = term or trunc
        assert steps <= 16
    assert INFO_KEYS <= set(info.keys())
    assert obs.shape == (3, 64, 64)
    frame = env.render()
    assert frame.shape == (64, 64, 3)
    np.testing.assert_array_equal(frame, obs.transpose(1, 2, 0))
    mobs, mr, mterm, mtrunc, minfo = env.unwrapped.mock_step()
    assert mobs.shape == (3, 64, 64) and mr == 0.0 and mtrunc and not mterm
    env.close()


def test_gym_video_close_path(tassets, tmp_path):
    pytest.importorskip("PIL")
    path = str(tmp_path / "episode.avi")
    env = _make(tassets, render_mode="video", video_filename=path,
                video_res=128, video_fov=100.0, ego_only=True)
    env.reset(seed=1)
    for _ in range(3):
        env.step(np.array([0.5, 0.0], np.float32))
    assert len(env.unwrapped._frames) == 4
    assert env.unwrapped._frames[0].shape == (3, 128, 128)
    env.close()
    assert os.path.exists(path) and os.path.getsize(path) > 1000


def test_gym_reset_seeding_deterministic(tassets):
    def first_obs(seed):
        env = _make(tassets)
        obs, _ = env.reset(seed=seed)
        env.close()
        return obs

    a, b, c = first_obs(9), first_obs(9), first_obs(10)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    # without a seed the episode follows cfg.seed
    env = _make(tassets)
    d, _ = env.reset()
    env2 = _make(tassets)
    np.testing.assert_array_equal(d, env2.reset()[0])


def test_policy_mode_episode(tassets):
    env = _make(tassets, npc_mode="policy")
    env.reset(seed=3)
    assert env.unwrapped._state.npc_hidden.shape == (1, 96, 16)
    for _ in range(3):
        obs, r, term, trunc, info = env.step(np.array([0.3, 0.0], np.float32))
    assert np.isfinite(r) and env.unwrapped._state.npc_hidden.abs().max() > 0


def test_mock_step_before_reset_and_the_device_rule(tassets):
    env = TorchGymEnv(_small_env_cfg(), data=tassets, device="cpu")
    obs, r, term, trunc, _ = env.mock_step()
    assert obs.shape == (3, 64, 64) and not obs.any() and trunc
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TorchGymEnv(_small_env_cfg(), data=tassets)


def _road_flips(got, want):
    bad = (got != want).any(axis=0)
    for img in (got, want):
        px = img.transpose(1, 2, 0)[bad]
        assert ((px == COLOR_ROAD) | (px == COLOR_BACKGROUND)).all(axis=-1).all()
    return int(bad.sum())


@pytest.mark.parametrize("npc_mode", ["route", "policy"])
def test_transitions_match_the_jax_adapter(assets_val, tassets, npc_mode):
    jenv = gym.make("torchdriveenv-v0",
                    args={"cfg": _small_env_cfg(jc, npc_mode=npc_mode),
                          "data": assets_val})
    tenv = _make(tassets, npc_mode=npc_mode)
    jobs, _ = jenv.reset(seed=5)
    tenv.reset(seed=5)
    jstate = jax.tree.map(lambda x: np.array(x)[None],
                          jenv.unwrapped._state)
    tenv.unwrapped._state = tcore.EnvState.from_numpy(jstate, device="cpu")
    assert (tenv.unwrapped._state.npc_hidden is None) == (npc_mode == "route")
    flips = _road_flips(tenv.unwrapped.render().transpose(2, 0, 1), jobs)
    rng = np.random.default_rng(0)
    for i in range(12):
        a = np.array([rng.uniform(-0.2, 1.0), rng.uniform(-0.1, 0.1)],
                     np.float32)
        jo, jr, jterm, jtrunc, jinfo = jenv.step(a)
        to, tr, tterm, ttrunc, tinfo = tenv.step(a)
        np.testing.assert_allclose(tr, jr, **GOLDEN_TOL, err_msg=f"step {i}")
        assert (tterm, ttrunc) == (jterm, jtrunc), f"step {i}"
        assert set(tinfo) == set(jinfo)
        for k in jinfo:
            assert tinfo[k].dtype == jinfo[k].dtype, k
            np.testing.assert_allclose(tinfo[k], jinfo[k], **GOLDEN_TOL,
                                       err_msg=f"step {i} {k}")
        flips += _road_flips(to, jo)
        if jterm or jtrunc:
            break
    assert i >= 5, "the episode ran a few steps"
    assert flips <= MAX_ROAD_FLIPS, flips
    np.testing.assert_allclose(
        tenv.unwrapped._state.agent_states.numpy()[0],
        np.asarray(jenv.unwrapped._state.agent_states), **GOLDEN_TOL)
