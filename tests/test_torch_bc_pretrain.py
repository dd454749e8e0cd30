"""The port's BC warm start (``tools/bc_pretrain.py``) against the JAX
tool's pieces.

- ``bc_loss`` and its gradients against the JAX tool's formula on the JAX
  actor (``SAC.actor.apply``) with the same f32 weights
  (``convert.params_from_torch``) on the same batch: the loss within 1e-6
  relative, each gradient within 1e-5 of its tensor's largest magnitude.
- ``collect_demo_pairs`` over 8 steps of 6 train envs against a
  ``lax.scan`` of the JAX scripted driver, ``step_fn``, ``update_stack``
  and ``unscale_action`` from the same states, every episode ending at
  a 5-step limit: the port is handed JAX's reset states, its first reset
  and each step's auto-reset draws (the port's own reset is held to JAX's
  in ``test_torch_core.py``). Stacks exact, actions within 1e-5.
- A tiny ``main`` writes a model-only checkpoint that ``rl.train.train
  (init_model=...)`` takes: the actor is the cloned one, its Adam count 0,
  log_alpha = log(0.05); through ``convert.sac_state_from_torch`` the JAX
  actor's tanh(mu) is the port's within 1e-5.
"""

import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env import batched as jbatched
from torchdriveenv_tpu.env import core as jcore
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu.rl import demo as jdemo
from torchdriveenv_tpu.rl import rollout as jrollout
from torchdriveenv_tpu_torch.config import EnvConfig as TEnvConfig
from torchdriveenv_tpu_torch.config import construct_rl_training_config
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.models.policies import SquashedGaussianActor
from torchdriveenv_tpu_torch.rl import train as train_mod
from torchdriveenv_tpu_torch.tools import bc_pretrain

torch.set_num_threads(2)
E, T = 6, 8
# episodes end at the time limit within the T steps: the auto-reset and the
# stacks' refill are part of what is compared
HORIZON = 5


def _jax_bc_loss(actor, params, obs, a):
    """The loss of ``tools/bc_pretrain.py`` (``bc_loss`` in its ``main``)."""
    mu, log_std = actor.apply(params, obs)
    a = jnp.clip(a, -0.98, 0.98)
    act_mse = ((jnp.tanh(mu) - a) ** 2).mean()
    std_pull = ((log_std - bc_pretrain.BC_LOG_STD) ** 2).mean()
    return act_mse + 0.05 * std_pull, act_mse


@pytest.mark.parametrize("seed", [0, 1])
def test_bc_loss_and_gradients_match_jax(seed):
    torch.manual_seed(seed)
    actor = SquashedGaussianActor(compute_dtype=torch.float32)
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (8, 9, 64, 64), dtype=np.uint8)
    # past the clip on both sides, like the scripted policy's full throttle
    a = rng.uniform(-1.2, 1.2, (8, 2)).astype(np.float32)
    loss, mse = bc_pretrain.bc_loss(actor, torch.from_numpy(obs),
                                    torch.from_numpy(a))
    names = [n for n, _ in actor.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in actor.named_parameters()])

    jactor = jpol.SquashedGaussianActor(compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray,
                          convert.params_from_torch(actor.state_dict()))
    (jloss, jmse), jgrads = jax.value_and_grad(
        functools.partial(_jax_bc_loss, jactor), has_aux=True)(
            params, jnp.asarray(obs), jnp.asarray(a))
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-6)
    assert float(mse.detach()) == pytest.approx(float(jmse), rel=1e-6)
    want = convert.params_to_torch(jax.tree.map(np.asarray, jgrads))
    assert sorted(want) == sorted(names)
    for n, g in zip(names, grads):
        w = want[n].numpy()
        scale = np.abs(w).max()
        assert scale > 0, n
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * scale, rtol=0,
                                   err_msg=n)


def test_bc_phase_lowers_the_loss_and_follows_its_generator():
    rng = np.random.default_rng(0)
    stacks = torch.from_numpy(rng.integers(0, 256, (32, 9, 64, 64),
                                           dtype=np.uint8))
    acts = torch.from_numpy(rng.uniform(-1, 1, (32, 2)).astype(np.float32))
    runs = []
    for _ in range(2):
        torch.manual_seed(0)
        actor = SquashedGaussianActor(compute_dtype=torch.float32)
        runs.append(bc_pretrain.bc_phase(actor, stacks, acts, 12, 32, 1e-3,
                                         torch.Generator().manual_seed(5)))
    mses = runs[0]
    assert mses.shape == (12,) and not mses.requires_grad
    assert float(mses[-3:].mean()) < float(mses[0])
    assert torch.equal(runs[0], runs[1])


@functools.lru_cache(maxsize=None)
def _jax_demo_scan():
    """The JAX tool's ``collect`` over T steps of E train envs -> (initial
    state, per-step fresh reset batches, stacks (T, E, 9, 64, 64), actions
    (T, E, 2), done flags (T, E))."""
    jassets = jload("train")
    cfg = JEnvConfig(max_environment_steps=HORIZON)
    reset_fn, step_fn = jbatched.make_env_fns(cfg, jassets, render=True)
    drv = jdemo.make_scripted_driver(cfg, jassets)
    keys = jax.random.split(jax.random.PRNGKey(11), E)

    def collect(keys):
        state, obs = reset_fn(keys)
        stack = jrollout.init_stack(obs, cfg.frame_stack)

        def one(c, _):
            state, stack = c
            # exact-mode auto-reset (E < reset_pool): the draws
            # batched._autoreset makes from the state's keys
            k_reset = jax.vmap(jax.random.split)(state.rng)[:, 0]
            fresh = jax.vmap(functools.partial(jcore.reset, cfg, jassets))(
                k_reset)
            a = drv(state)
            out = step_fn(state, a)
            pair = (stack, jpol.unscale_action(a))
            done = out.terminated | out.truncated
            stack = jrollout.update_stack(stack, out.obs, done)
            return (out.state, stack), (pair, fresh, done)
        _, ((stacks, acts), fresh, done) = jax.lax.scan(
            one, (state, stack), None, length=T)
        return state, fresh, stacks, acts, done

    out = jax.jit(collect)(keys)
    return jax.tree.map(np.asarray, out)


def test_collect_demo_pairs_matches_jax(monkeypatch):
    state0, fresh, stacks, acts, done = _jax_demo_scan()
    tassets = tload("train", device="cpu")
    handed = [tcore.EnvState.from_numpy(state0, device="cpu")] + [
        tcore.EnvState.from_numpy(jax.tree.map(lambda x, t=t: x[t], fresh),
                                  device="cpu") for t in range(T)]
    monkeypatch.setattr(tcore, "reset_from_draws",
                        lambda cfg, assets, draws: handed.pop(0))
    got_s, got_a = bc_pretrain.collect_demo_pairs(
        TEnvConfig(max_environment_steps=HORIZON), tassets, E, T,
        torch.Generator().manual_seed(0))
    assert not handed
    assert done[HORIZON - 1].all() and done.sum() == E
    assert got_s.shape == (T * E, 9, 64, 64) and got_s.dtype == torch.uint8
    assert got_a.shape == (T * E, 2) and got_a.dtype == torch.float32
    np.testing.assert_array_equal(got_s.numpy(),
                                  stacks.reshape((T * E,) + stacks.shape[2:]))
    np.testing.assert_allclose(got_a.numpy(), acts.reshape(T * E, 2),
                               atol=1e-5, rtol=0)
    assert np.abs(acts).max() <= 1.0 + 1e-6
    # the steps exercise the scripted policy: it brakes, speeds up and steers
    assert (acts[..., 0] < 0).any() and (acts[..., 0] > 0).any()
    assert np.abs(acts[..., 1]).max() > 0.05
    assert stacks.reshape(T * E, -1).std(1).min() > 0


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bc") / "bc_init")
    res = bc_pretrain.main(["--envs", "4", "--rollout_steps", "6",
                            "--bc_steps", "3", "--batch", "8",
                            "--device", "cpu", "--out", out])
    return res, torch.load(out, weights_only=True)


def test_tiny_run_writes_a_warm_start(tiny_run):
    res, tree = tiny_run
    assert res["pairs"] == 24 and res["mses"].shape == (3,)
    assert sorted(tree) == sorted(
        ["actor", "critic", "target_critic", "log_alpha", "step",
         "actor_opt", "critic_opt", "alpha_opt"])
    assert tree["step"] == 0
    for k in ("actor_opt", "critic_opt", "alpha_opt"):
        assert tree[k]["step"] == 0, k
        assert all(not v.any() for v in tree[k]["exp_avg"].values()), k
    assert float(tree["log_alpha"]) == pytest.approx(math.log(0.05), rel=1e-6)
    for k, v in tree["critic"].items():
        assert torch.equal(v, tree["target_critic"][k]), k
    # the actor moved away from SAC's initialisation of the same seed
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    fresh = SAC(SACConfig(init_alpha=0.05)).init(seed=1, device="cpu")
    assert any(not torch.equal(v, fresh.actor.state_dict()[k])
               for k, v in tree["actor"].items())
    for k, v in tree["critic"].items():
        assert torch.equal(v, fresh.critic.state_dict()[k]), k


def test_rl_train_takes_the_warm_start(tiny_run, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    res, tree = tiny_run
    cfg = construct_rl_training_config(dict(
        algorithm="sac", parallel_env_num=2, total_timesteps=4,
        offpolicy_steps_per_iter=2, offpolicy_updates_per_iter=1,
        log_dir=os.path.join(str(tmp_path), "runs"),
        checkpoint_dir=os.path.join(str(tmp_path), "ckpt"),
        env=dict(max_environment_steps=3, device="cpu", seed=3),
        eval_val_callback=dict(n_steps=10 ** 6, eval_n_episodes=1,
                               record=False),
        eval_train_callback=dict(n_steps=10 ** 6, eval_n_episodes=1),
        wandb_callback=dict(model_save_freq=10 ** 6)))
    carry = train_mod.train(cfg, init_model=res["path"])
    st = carry.agent_state
    assert carry.env_steps == 4                    # warm-up: no update ran
    for k, v in st.actor.state_dict().items():
        assert torch.equal(v, tree["actor"][k]), k
    assert not st.actor_opt.state or all(
        int(s["step"]) == 0 for s in st.actor_opt.state.values())
    assert float(st.log_alpha) == pytest.approx(math.log(0.05), rel=1e-6)
    saved = torch.load(os.path.join(cfg.checkpoint_dir, "model_4"),
                       weights_only=True)
    assert saved["actor_opt"]["step"] == 0
    for k, v in saved["actor"].items():
        assert torch.equal(v, tree["actor"][k]), k


def test_the_warm_start_carries_into_the_jax_actor(tiny_run):
    _, tree = tiny_run
    actor = SquashedGaussianActor(compute_dtype=torch.float32)
    actor.load_state_dict(tree["actor"])
    jstate = convert.sac_state_from_torch(tree)
    jactor = jpol.SquashedGaussianActor(compute_dtype=jnp.float32)
    obs = np.random.default_rng(3).integers(0, 256, (16, 9, 64, 64),
                                            dtype=np.uint8)
    mu, _ = jactor.apply(jax.tree.map(jnp.asarray, jstate["actor_params"]),
                         jnp.asarray(obs))
    with torch.no_grad():
        tmu, _ = actor(torch.from_numpy(obs))
    np.testing.assert_allclose(torch.tanh(tmu).numpy(),
                               np.asarray(jnp.tanh(mu)), atol=1e-5, rtol=0)
    assert float(jstate["log_alpha"]) == pytest.approx(math.log(0.05),
                                                       rel=1e-6)
