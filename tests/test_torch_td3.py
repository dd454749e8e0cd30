"""The port's TD3 (``rl/td3.py``) against the JAX package's: four
consecutive updates from ``step`` 0 (two that move the actor and the
targets, two that do not) from carried-over weights, with the same batches
and the same target-smoothing noise; the order inside an update (the
actor's loss goes through the critic AFTER its step); and acting.

The tolerance is that of ``tests/test_torch_sac.py`` and
``tests/test_torch_ppo.py`` (metrics rtol 1e-4 / atol 1e-5, counters exact,
tensors atol plus 1e-5 of their largest magnitude, outliers bounded by count
and size), with its atol of 2e-5 at SAC's lr of 3e-4 scaled to TD3's lr of
1e-3, as those tests scale it for a larger lr: what separates the two sides
after an Adam step is rounding noise times lr, and from the second update on
the moments inherit it through the parameters.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ppo import _assert_close
from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu.rl import td3 as jtd3
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.rl import td3 as ttd3

torch.set_num_threads(2)
B, RES = 8, 20
STATE_KEYS = ("actor_params", "target_actor_params", "critic_params",
              "target_critic_params", "actor_opt", "critic_opt", "step")
NETS = ("actor", "target_actor", "critic", "target_critic")
ATOL = 2e-5 * 1e-3 / 3e-4


def _jax_agent(**cfg):
    agent = jtd3.TD3(jtd3.TD3Config(**cfg))
    agent.actor = jpol.DeterministicActor(compute_dtype=jnp.float32)
    agent.critic = jpol.DoubleQCritic(compute_dtype=jnp.float32)
    return agent


def _tree_of(jstate):
    return {k: jax.tree.map(np.asarray, getattr(jstate, k))
            for k in STATE_KEYS}


def _both(**cfg):
    jagent = _jax_agent(**cfg)
    jstate = jagent.init(jax.random.PRNGKey(0), obs_res=RES)
    tagent = ttd3.TD3(ttd3.TD3Config(**cfg), compute_dtype=torch.float32)
    tagent.init(seed=1, obs_res=RES, device="cpu")
    tagent.load_state(convert.td3_state_to_torch(_tree_of(jstate), RES))
    return jagent, jstate, tagent


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 256, (B, 9, RES, RES), dtype=np.uint8),
        next_obs=rng.integers(0, 256, (B, 9, RES, RES), dtype=np.uint8),
        action=rng.uniform(-1, 1, (B, 2)).astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        discount_mask=(rng.random(B) > 0.25).astype(np.float32),
        done=rng.random(B) < 0.25,
        is_demo=np.zeros(B, bool))


def _torch_batch(seed):
    """``_batch(seed)`` as torch tensors, with the rows' places in the batch
    (``pos``) that ``buffer.sample`` returns beside them."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed).items()}
    batch["pos"] = torch.arange(B)
    return batch


def _assert_states_close(tagent, jstate, where, param_atol=ATOL,
                         moment_atol=ATOL):
    want = convert.td3_state_to_torch(_tree_of(jstate), RES)
    got = tagent.export_state()
    assert got["step"] == want["step"], where
    for net in NETS:
        assert sorted(got[net]) == sorted(want[net])
        for k in want[net]:
            _assert_close(got[net][k], want[net][k], f"{where}: {net}.{k}",
                          param_atol)
    for opt in convert.TD3_OPT_KEYS:
        assert got[opt]["step"] == want[opt]["step"], (where, opt)
        for moment in ("exp_avg", "exp_avg_sq"):
            for k in want[opt][moment]:
                _assert_close(got[opt][moment][k], want[opt][moment][k],
                              f"{where}: {opt}.{moment}.{k}", moment_atol)


def _snapshot(tagent):
    return copy.deepcopy({k: getattr(tagent.state, k).state_dict()
                          for k in NETS})


def _same(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def test_four_updates_match_jax():
    jagent, jstate, tagent = _both()
    jupdate = jax.jit(jagent.update)
    _assert_states_close(tagent, jstate, "start")
    for u in range(4):
        batch, key = _batch(50 + u), jax.random.PRNGKey(60 + u)
        before = _snapshot(tagent)
        jstate, jm = jupdate(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        noise = torch.from_numpy(np.array(jax.random.normal(key, (B, 2))))
        tm = tagent.update(_torch_batch(50 + u), noise=noise)
        assert sorted(tm) == sorted(jm) == sorted(ttd3.TD3.metric_names)
        for k in jm:
            np.testing.assert_allclose(
                float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                err_msg=f"update {u + 1}: metric {k}")
        _assert_states_close(tagent, jstate, f"update {u + 1}")
        # updates 1 and 3 (step 0 and 2 at entry) move the actor and both
        # targets; 2 and 4 move the critic alone and report a zero loss
        after = _snapshot(tagent)
        delayed = u % 2 == 1
        assert not _same(before["critic"], after["critic"])
        for net in ("actor", "target_actor", "target_critic"):
            assert _same(before[net], after[net]) == delayed, (u, net)
        assert (float(tm["actor_loss"]) == 0.0) == delayed
        exported = tagent.export_state()
        assert exported["critic_opt"]["step"] == u + 1
        assert exported["actor_opt"]["step"] == u // 2 + 1
        assert int(jstate.actor_opt[0].count) == u // 2 + 1
    st = tagent.state
    assert all(p.grad is None for m in (st.actor, st.critic)
               for p in m.parameters())


def test_the_actor_gradient_goes_through_the_stepped_critic():
    """With a large learning rate the critic moves far in its step. The
    actor's first Adam moment (0.1 x its gradient, from zero moments) must
    be the gradient through the critic as it BECAME, not as it was: the
    mirror of SAC's order. Nothing of it lands on the critic, whose own
    moment holds the critic loss's gradient alone."""
    cfg = dict(lr=0.05)
    jagent, jstate, tagent = _both(**cfg)
    pre_actor = copy.deepcopy(tagent.state.actor)
    pre_critic = copy.deepcopy(tagent.state.critic)
    batch = _torch_batch(0)
    key = jax.random.PRNGKey(10)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, 2))))
    tagent.update(batch, noise=noise)
    post_critic = tagent.state.critic

    def actor_grad(critic):
        actor = copy.deepcopy(pre_actor)
        loss = -critic(batch["obs"], actor(batch["obs"]))[0].mean()
        return dict(zip((n for n, _ in actor.named_parameters()),
                        torch.autograd.grad(loss, list(actor.parameters()))))

    g_pre, g_post = actor_grad(pre_critic), actor_grad(post_critic)
    moments = tagent.export_state()["actor_opt"]["exp_avg"]
    far = 0.0
    for k, m in moments.items():
        np.testing.assert_allclose(m.numpy(), 0.1 * g_post[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
        far = max(far, float((g_pre[k] - g_post[k]).abs().max()))
    assert far > 1e-2, "the moved critic gives another actor gradient"

    with torch.no_grad():
        smooth = torch.clamp(0.2 * noise, -0.5, 0.5)
        next_a = torch.clamp(pre_actor(batch["next_obs"]) + smooth, -1, 1)
        tq = torch.minimum(*pre_critic(batch["next_obs"], next_a))
        target_q = batch["reward"] + 0.99 * batch["discount_mask"] * tq
    critic = copy.deepcopy(pre_critic)
    q1, q2 = critic(batch["obs"], batch["action"])
    loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
    grads = torch.autograd.grad(loss, list(critic.parameters()))
    c_moments = tagent.export_state()["critic_opt"]["exp_avg"]
    for (k, _), g in zip(critic.named_parameters(), grads):
        np.testing.assert_allclose(c_moments[k].numpy(), 0.1 * g.numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)

    # and the JAX package orders it the same way; a first Adam step moves
    # every element by about lr, so the parameters' tolerance scales with it
    jstate, _ = jax.jit(jagent.update)(
        jstate, {k: jnp.asarray(v) for k, v in _batch(0).items()}, key)
    _assert_states_close(tagent, jstate, "lr 0.05, one update",
                         param_atol=ATOL * 0.05 / 1e-3, moment_atol=2e-5)


def test_select_action_matches_jax():
    jagent, jstate, tagent = _both()
    obs = _batch(3)["obs"]
    key = jax.random.PRNGKey(2)
    want = np.asarray(jagent.select_action(jstate, jnp.asarray(obs), key))
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, 2))))
    got = tagent.select_action(torch.from_numpy(obs), noise=noise)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    det = tagent.select_action(torch.from_numpy(obs), deterministic=True)
    np.testing.assert_allclose(
        det.numpy(), np.asarray(jagent.select_action(
            jstate, jnp.asarray(obs), key, deterministic=True)), atol=1e-5)
    assert not got.requires_grad and not torch.equal(got, det)
    # exploration clips to the box after adding the noise
    loud = tagent.select_action(torch.from_numpy(obs),
                                noise=torch.full((B, 2), 100.0))
    assert torch.equal(loud, torch.ones(B, 2))
    g = torch.Generator().manual_seed(0)
    drawn = torch.randn(B, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tagent.select_action(torch.from_numpy(obs), g),
                       tagent.select_action(torch.from_numpy(obs),
                                            noise=drawn))


def test_config_defaults_and_init():
    j, t = jtd3.TD3Config(), ttd3.TD3Config()
    for f in ("lr", "gamma", "tau", "batch_size", "buffer_size",
              "learning_starts", "policy_delay", "target_noise", "noise_clip",
              "explore_noise"):
        assert getattr(j, f) == getattr(t, f), f
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttd3.TD3().init()
    st = ttd3.TD3(compute_dtype=torch.float32).init(seed=3, obs_res=RES,
                                                    device="cpu")
    for net, target in ((st.actor, st.target_actor),
                        (st.critic, st.target_critic)):
        for p, q in zip(net.parameters(), target.parameters()):
            assert torch.equal(p, q) and p.requires_grad and not q.requires_grad
    assert st.actor_opt.defaults["lr"] == 1e-3 == st.critic_opt.defaults["lr"]
    assert st.critic_opt.defaults["eps"] == 1e-8
