"""The port's batched env (``make_env_fns``, pooled auto-reset,
``BatchedEnv``) on the CPU, and its pool consumption against JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env import batched as jbatched
from torchdriveenv_tpu.env import core as jcore
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu_torch.config import EnvConfig as TEnvConfig
from torchdriveenv_tpu_torch.env import batched as tbatched
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.ops import rasterizer_cuda as trc

torch.set_num_threads(2)
B = 8


@pytest.fixture(scope="module")
def tassets():
    return tload("val", device="cpu")


def _actions():
    return torch.tensor([[0.4, 0.05]]).repeat(B, 1)


def _rollout(tassets, with_final_obs, steps=4):
    # episodes of 3 steps: every env finishes at step 3, more than the pool
    cfg = TEnvConfig(reset_pool=4, max_environment_steps=3)
    reset_fn, step_fn = tbatched.make_env_fns(cfg, tassets,
                                              with_final_obs=with_final_obs)
    g = torch.Generator().manual_seed(0)
    state, obs = reset_fn(g, B)
    outs = []
    for _ in range(steps):
        out = step_fn(state, _actions(), g)
        outs.append(out)
        state = out.state
    return cfg, obs, outs


@pytest.mark.parametrize("with_final_obs", [False, True])
def test_step_output_shapes_and_dtypes(tassets, with_final_obs):
    _, obs0, outs = _rollout(tassets, with_final_obs)
    assert obs0.shape == (B, 3, 64, 64) and obs0.dtype == torch.uint8
    for out in outs:
        assert out.obs.shape == (B, 3, 64, 64) and out.obs.dtype == torch.uint8
        assert out.reward.shape == (B,) and out.reward.dtype == torch.float32
        assert out.terminated.dtype == out.truncated.dtype == torch.bool
        assert out.state.agent_states.shape == (B, 96, 4)
        for k, v in out.info.items():
            assert v.shape == (B,), k
        if with_final_obs:
            assert out.final_obs.shape == (B, 3, 64, 64)
        else:
            assert out.final_obs is None
    # step 3 truncates every env; the pooled reset restarts them all
    assert outs[2].truncated.all()
    assert (outs[2].state.step_idx == 0).all()
    assert (outs[3].state.step_idx == 1).all()


def test_obs_is_the_render_of_the_returned_state(tassets):
    cfg, _, outs = _rollout(tassets, with_final_obs=True)
    for out in outs:
        want = tbatched._obs_batched(cfg, tassets, out.state)
        assert torch.equal(out.obs, want)
        done = out.terminated | out.truncated
        # non-done envs: the pre-reset frame is the frame of their state
        assert torch.equal(out.final_obs[~done], out.obs[~done])


def test_obs_batched_uses_the_twin_on_cpu(tassets):
    cfg = TEnvConfig()
    g = torch.Generator().manual_seed(1)
    state = tcore.reset(cfg, tassets, 4, g)
    t = state.time0 + state.step_idx.float() * cfg.simulator.dt
    case = state.case.long()
    prep = trc.prepare_obs_inputs(
        tassets.maps, state.town, t, state.agent_states, state.agent_attrs,
        state.present, tassets.suite.waypoints[case], state.target_idx,
        tassets.suite.n_waypoints[case], fov=70.0)
    want = trc.render_obs_torch(tassets.maps, state.town, *prep)
    assert torch.equal(tbatched._obs_batched(cfg, tassets, state), want)


def test_pool_consumption_matches_jax(tassets):
    """Given the same fresh pool and done mask, the same envs take the same
    pool entries as in JAX's _autoreset."""
    jassets = jload("val")
    jcfg = JEnvConfig(reset_pool=4)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(B, dtype=jnp.uint32))
    nxt = jax.jit(jax.vmap(functools.partial(jcore.reset, jcfg, jassets)))(keys)
    done = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)      # 6 done > pool of 4
    out, pool, idx = jax.jit(functools.partial(jbatched._autoreset, jcfg,
                                               jassets))(nxt, jnp.asarray(done))
    np_tree = functools.partial(jax.tree.map, np.array)
    t_out, t_idx = tbatched._consume_pool(
        tcore.EnvState.from_numpy(np_tree(nxt), device="cpu"),
        torch.from_numpy(done),
        tcore.EnvState.from_numpy(np_tree(pool), device="cpu"))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(idx))
    for k in tcore._FIELDS:
        np.testing.assert_array_equal(getattr(t_out, k).numpy(),
                                      np.asarray(getattr(out, k)), err_msg=k)


def test_exact_mode_resets_every_done_env(tassets):
    cfg = TEnvConfig(reset_pool=0, max_environment_steps=2)
    env = tbatched.BatchedEnv(cfg, tassets, 4, device="cpu", seed=5)
    state, _ = env.reset()
    for _ in range(2):
        out = env.step(state, _actions()[:4])
        state = out.state
    assert out.truncated.all() and (state.step_idx == 0).all()


def test_batched_env_without_device_needs_a_gpu(tassets):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbatched.BatchedEnv(TEnvConfig(), tassets, B)


@pytest.mark.parametrize("with_final_obs", [False, True])
def test_policy_mode_restarts_done_envs_from_zero_hidden(tassets,
                                                         with_final_obs):
    """Policy mode through the pooled auto-reset (every env ends at step 3,
    more than the pool holds): the GRU's hidden state moves while an
    episode runs and is zero again in every env that restarted."""
    cfg = TEnvConfig(npc_mode="policy", reset_pool=4, max_environment_steps=3)
    reset_fn, step_fn = tbatched.make_env_fns(cfg, tassets,
                                              with_final_obs=with_final_obs)
    g = torch.Generator().manual_seed(2)
    state, _ = reset_fn(g, B)
    assert state.npc_hidden.shape == (B, 96, 16) and not state.npc_hidden.any()
    for i in range(4):
        out = step_fn(state, _actions(), g)
        state = out.state
        running = state.step_idx > 0
        assert (state.npc_hidden[running].abs().amax(dim=(1, 2)) > 0).all()
        assert not state.npc_hidden[~running].any()
        assert torch.equal(out.obs, tbatched._obs_batched(cfg, tassets, state))
    assert (~running).sum() == 0 and i == 3


def test_policy_pool_consumption_takes_zero_hidden(tassets):
    """Done envs take pool entries with their (zero) hidden rows; the others
    keep theirs."""
    cfg = TEnvConfig(npc_mode="policy")
    g = torch.Generator().manual_seed(3)
    nxt = tcore.reset(cfg, tassets, B, g)
    nxt = nxt.replace(npc_hidden=torch.randn(nxt.npc_hidden.shape, generator=g))
    pool = tcore.reset(cfg, tassets, 4, g)
    done = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.bool)
    out, idx = tbatched._consume_pool(nxt, done, pool)
    assert not out.npc_hidden[done].any()
    assert torch.equal(out.npc_hidden[~done], nxt.npc_hidden[~done])
    assert torch.equal(out.agent_states[done], pool.agent_states[idx[done]])


def test_route_mode_carries_no_hidden_state(tassets):
    _, _, outs = _rollout(tassets, with_final_obs=True)
    assert all(out.state.npc_hidden is None for out in outs)
