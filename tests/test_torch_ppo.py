"""The port's PPO (``rl/ppo.py``) against the JAX package's: GAE and the
truncation bootstrap on random rollouts (atol 1e-6) and on the manual cases
of ``tests/test_rl.py``; ``select_action`` with the noise handed over (atol
1e-5); one and three whole ``update``s from carried-over weights with JAX's
own permutations; optax's global-norm clip on both sides of ``max_norm``;
and the committed PPO checkpoint carried across and back.

Tolerances of the updates are those of ``tests/test_torch_sac.py``: the four
metrics rtol 1e-4 / atol 1e-5, the counters exact, every parameter and Adam
moment atol 2e-5 plus 1e-5 of the tensor's largest magnitude, with at most 4
elements of a tensor (or 1e-5 of it) over that, by no more than 100 times:
an Adam step on an element whose gradient is within rounding of zero moves
by a fraction of lr whatever the arithmetic. Both sides compute in f32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu.rl import ppo as jppo
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.rl import optim as toptim
from torchdriveenv_tpu_torch.rl import ppo as tppo

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "ppo1024_ckpt", "model_50003968")
T, E, RES = 6, 8, 20
ATOL, SCALE_RTOL = 2e-5, 1e-5
STATE_KEYS = ("params", "opt", "step")


# --------------------------------------------------------------------------
# GAE and the truncation bootstrap
# --------------------------------------------------------------------------


def _random_rollout(seed, t=12, e=5):
    rng = np.random.default_rng(seed)
    term = rng.random((t, e)) < 0.15
    trunc = rng.random((t, e)) < 0.15           # some steps end both ways
    return dict(reward=rng.normal(size=(t, e)).astype(np.float32),
                value=rng.normal(size=(t, e)).astype(np.float32),
                v_final=rng.normal(size=(t, e)).astype(np.float32),
                last_value=rng.normal(size=e).astype(np.float32),
                terminated=term, truncated=trunc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gae_and_bootstrap_match_jax(seed):
    r = _random_rollout(seed)
    assert r["terminated"].any() and (r["truncated"] & ~r["terminated"]).any()
    gamma, lam = 0.99, 0.95
    j = {k: jnp.asarray(v) for k, v in r.items()}
    t = {k: torch.from_numpy(v) for k, v in r.items()}
    jboot = jppo.bootstrap_truncated_rewards(
        j["reward"], j["terminated"], j["truncated"], j["v_final"], gamma)
    tboot = tppo.bootstrap_truncated_rewards(
        t["reward"], t["terminated"], t["truncated"], t["v_final"], gamma)
    np.testing.assert_allclose(tboot.numpy(), np.asarray(jboot), atol=1e-6)
    jadv, jret = jppo.compute_gae(jboot, j["value"],
                                  j["terminated"] | j["truncated"],
                                  j["last_value"], gamma, lam)
    tadv, tret = tppo.compute_gae(tboot, t["value"],
                                  t["terminated"] | t["truncated"],
                                  t["last_value"], gamma, lam)
    assert tadv.shape == tret.shape == (12, 5) and tadv.dtype == torch.float32
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=1e-6)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-6)


def test_gae_matches_manual():
    """T=3, E=1, no dones: the backward recursion by hand."""
    r, v = torch.ones(3, 1), torch.full((3, 1), 0.5)
    gamma, lam = 0.9, 0.8
    adv, ret = tppo.compute_gae(r, v, torch.zeros(3, 1, dtype=torch.bool),
                                torch.tensor([0.5]), gamma, lam)
    expect, a_next = np.zeros(3), 0.0
    for t in (2, 1, 0):
        a_next = (1.0 + gamma * 0.5 - 0.5) + gamma * lam * a_next
        expect[t] = a_next
    np.testing.assert_allclose(adv[:, 0].numpy(), expect, atol=1e-6)
    assert torch.equal(ret, adv + v)


def test_terminated_cuts_truncated_bootstraps():
    """GAE cuts at every done, but a time-limit truncation first folds
    gamma * V(final_obs) into the reward; a real termination gets nothing."""
    gamma, lam = 0.99, 0.95
    zeros = torch.zeros(2, 2)
    term = torch.tensor([[True, False], [False, False]])
    trunc = torch.tensor([[False, True], [False, False]])
    v_final = torch.tensor([[7.0, 7.0], [0.0, 0.0]])
    r_boot = tppo.bootstrap_truncated_rewards(zeros, term, trunc, v_final,
                                              gamma)
    assert float(r_boot[0, 0]) == 0.0
    assert float(r_boot[0, 1]) == pytest.approx(gamma * 7.0)
    adv, _ = tppo.compute_gae(r_boot, zeros, term | trunc,
                              torch.tensor([100.0, 100.0]), gamma, lam)
    assert float(adv[0, 0]) == 0.0
    assert float(adv[0, 1]) == pytest.approx(gamma * 7.0)
    # both at once is a termination
    both = tppo.bootstrap_truncated_rewards(
        zeros[:1], torch.tensor([[True, True]]), torch.tensor([[True, True]]),
        v_final[:1], gamma)
    assert not both.any()


# --------------------------------------------------------------------------
# the agent
# --------------------------------------------------------------------------


def _jax_agent(**cfg):
    agent = jppo.PPO(jppo.PPOConfig(**cfg))
    agent.net = jpol.GaussianActorCritic(compute_dtype=jnp.float32)
    return agent


def _tree_of(jstate):
    return {k: jax.tree.map(np.asarray, getattr(jstate, k))
            for k in STATE_KEYS}


def _torch_agent(tree, res=RES, **cfg):
    agent = tppo.PPO(tppo.PPOConfig(**cfg), compute_dtype=torch.float32)
    agent.init(seed=1, obs_res=res, device="cpu")
    agent.load_state(convert.ppo_state_to_torch(tree, res))
    return agent


def _fresh(seed=0, **cfg):
    jagent = _jax_agent(**cfg)
    jstate = jagent.init(jax.random.PRNGKey(seed), obs_res=RES)
    return jagent, jstate, _torch_agent(_tree_of(jstate), **cfg)


def _rollout(seed, jagent, jstate, reward_scale=1.0):
    """A rollout whose actions, log-probs and values are the policy's own
    (as the train step stores them), on random frames."""
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (T, E, 9, RES, RES), dtype=np.uint8)
    a, logp, value = jagent.select_action(
        jstate, jnp.asarray(obs.reshape((T * E,) + obs.shape[2:])),
        jax.random.PRNGKey(seed))
    return dict(
        obs=obs, action=np.asarray(a).reshape(T, E, 2),
        log_prob=np.asarray(logp).reshape(T, E),
        value=np.asarray(value).reshape(T, E),
        reward=(reward_scale * rng.normal(size=(T, E))).astype(np.float32),
        done=rng.random((T, E)) < 0.2,
    ), (reward_scale * rng.normal(size=E)).astype(np.float32)


def _perms(key, n_epochs, n):
    """The permutations ``jppo.PPO.update`` draws from ``key``."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.permutation(k, n))
        for k in jax.random.split(key, n_epochs)]).astype(np.int64))


def _assert_close(got, want, name, atol=ATOL):
    assert got.shape == want.shape and got.dtype == want.dtype, name
    diff = (got - want).abs()
    tol = atol + SCALE_RTOL * float(want.abs().max())
    n_over = int((diff > tol).sum())
    assert n_over <= max(4, got.numel() * 1e-5), (
        f"{name}: {n_over} of {got.numel()} elements over {tol:.3g}, "
        f"max {float(diff.max()):.3g}")
    assert float(diff.max()) <= 100 * tol, (
        f"{name}: max difference {float(diff.max()):.3g} over 100 x {tol:.3g}")


def assert_states_close(tagent, jstate, where, to_torch=None, res=RES):
    want = (to_torch or convert.ppo_state_to_torch)(_tree_of(jstate), res)
    got = tagent.export_state()
    assert got["step"] == want["step"], where
    assert got["opt"]["step"] == want["opt"]["step"], where
    assert sorted(got["net"]) == sorted(want["net"])
    for k in want["net"]:
        _assert_close(got["net"][k], want["net"][k], f"{where}: {k}")
        for moment in ("exp_avg", "exp_avg_sq"):
            _assert_close(got["opt"][moment][k], want["opt"][moment][k],
                          f"{where}: {moment}.{k}")


def test_select_action_matches_jax():
    jagent, jstate, tagent = _fresh()
    obs = np.random.default_rng(5).integers(0, 256, (E, 9, RES, RES),
                                            dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    ja, jlogp, jv = jagent.select_action(jstate, jnp.asarray(obs), key)
    noise = torch.from_numpy(np.asarray(jax.random.normal(key, (E, 2))))
    ta, tlogp, tv = tagent.select_action(torch.from_numpy(obs), noise=noise)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    assert not ta.requires_grad and tlogp.shape == tv.shape == (E,)
    # the sample is RAW: std is 1 at the start, so some leave the box
    assert float(ta.abs().max()) > 1.0
    # deterministic: the mean, a zero log-prob, the same value
    mu, zero, v = tagent.select_action(torch.from_numpy(obs),
                                       deterministic=True)
    jmu, jzero, _ = jagent.select_action(jstate, jnp.asarray(obs), key,
                                         deterministic=True)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-5)
    assert not zero.any() and zero.shape == jzero.shape and torch.equal(v, tv)
    assert torch.equal(tagent.value(torch.from_numpy(obs)), tv)
    # drawn from a generator when no noise is handed over
    g = torch.Generator().manual_seed(0)
    drawn = torch.randn(E, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(tagent.select_action(torch.from_numpy(obs), g)[0],
                       tagent.select_action(torch.from_numpy(obs),
                                            noise=drawn)[0])


@pytest.mark.parametrize("n_updates", [1, 3])
def test_update_matches_jax(n_updates):
    # 48 transitions, minibatches of 16, 2 epochs: 6 gradient steps per update
    cfg = dict(batch_size=16, n_epochs=2)
    jagent, jstate, tagent = _fresh(**cfg)
    assert_states_close(tagent, jstate, "start")
    for u in range(n_updates):
        ro, last_value = _rollout(20 + u, jagent, jstate)
        key = jax.random.PRNGKey(40 + u)
        jstate, jm = jagent.update(
            jstate, {k: jnp.asarray(v) for k, v in ro.items()},
            jnp.asarray(last_value), key)
        tm = tagent.update({k: torch.from_numpy(v) for k, v in ro.items()},
                           torch.from_numpy(last_value),
                           perms=_perms(key, 2, T * E))
        assert sorted(tm) == sorted(jm) == sorted(tppo.PPO.metric_names)
        for k in jm:
            np.testing.assert_allclose(
                float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                err_msg=f"update {u + 1}: metric {k}")
        assert_states_close(tagent, jstate, f"update {u + 1}")
        assert tagent.state.step == u + 1
        assert tagent.export_state()["opt"]["step"] == 6 * (u + 1)
    assert all(p.grad is None for p in tagent.state.net.parameters())


def test_minibatches_drop_the_remainder_and_need_a_full_batch():
    """48 transitions in minibatches of 20: two per epoch, 8 left over; a
    rollout under one minibatch cannot be sliced (in JAX neither)."""
    jagent, jstate, tagent = _fresh(batch_size=20, n_epochs=1)
    ro, last_value = _rollout(7, jagent, jstate)
    key = jax.random.PRNGKey(8)
    jstate, jm = jagent.update(
        jstate, {k: jnp.asarray(v) for k, v in ro.items()},
        jnp.asarray(last_value), key)
    tro = {k: torch.from_numpy(v) for k, v in ro.items()}
    tm = tagent.update(tro, torch.from_numpy(last_value),
                       perms=_perms(key, 1, T * E))
    assert tagent.export_state()["opt"]["step"] == 2
    assert_states_close(tagent, jstate, "two minibatches of 20")
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-4, atol=1e-5)
    big = tppo.PPO(tppo.PPOConfig(batch_size=T * E + 1),
                   compute_dtype=torch.float32)
    big.init(seed=0, obs_res=RES, device="cpu")
    with pytest.raises(ValueError, match="minibatch"):
        big.update(tro, torch.from_numpy(last_value))


def test_update_draws_its_permutations_from_the_generator():
    _, _, a = _fresh(batch_size=16, n_epochs=2)
    jagent, jstate, b = _fresh(batch_size=16, n_epochs=2)
    ro, last_value = _rollout(9, jagent, jstate)
    tro = {k: torch.from_numpy(v) for k, v in ro.items()}
    g = torch.Generator().manual_seed(4)
    perms = torch.stack([torch.randperm(T * E, generator=g) for _ in range(2)])
    a.update(tro, torch.from_numpy(last_value), perms=perms)
    b.update(tro, torch.from_numpy(last_value),
             generator=torch.Generator().manual_seed(4))
    for p, q in zip(a.state.net.parameters(), b.state.net.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("side", ["under", "over"])
def test_global_norm_clip_matches_optax(side):
    """optax leaves gradients under ``max_norm`` untouched and scales the
    others to it exactly; torch's own helper would shrink both by
    ``norm + 1e-6``. Held on the clip alone and through one A2C-sized
    update whose gradient norm lies on the named side of 0.5."""
    rng = np.random.default_rng(0)
    grads = [rng.normal(size=s).astype(np.float32) * (0.01 if side == "under"
                                                      else 1.0)
             for s in ((4, 3), (7,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(0.5).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = toptim.clip_by_global_norm_(got, 0.5)
    true_norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
    assert (true_norm < 0.5) == (side == "under")
    assert float(norm) == pytest.approx(true_norm, rel=1e-6)
    for g, w, raw in zip(got, want, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        if side == "under":
            assert np.array_equal(g.numpy(), raw)       # untouched, bit for bit
    if side == "over":
        clipped = np.sqrt(sum((g.numpy().astype(np.float64) ** 2).sum()
                              for g in got))
        assert clipped == pytest.approx(0.5, rel=1e-6)

    # through an update: rewards scaled so the loss's gradient lands there
    scale = 1e-3 if side == "under" else 30.0
    cfg = dict(batch_size=T * E, n_epochs=1, ent_coef=0.0)
    jagent, jstate, tagent = _fresh(**cfg)
    ro, last_value = _rollout(11, jagent, jstate, reward_scale=scale)
    ro["value"] = (scale * ro["value"]).astype(np.float32)
    tro = {k: torch.from_numpy(v) for k, v in ro.items()}
    perms = _perms(jax.random.PRNGKey(0), 1, T * E)
    # the norm this update's gradient has, from a copy of the agent
    probe = _torch_agent(_tree_of(jstate), **cfg)
    seen = {}
    plain = toptim.clip_by_global_norm_
    tppo.clip_by_global_norm_ = lambda g, m: seen.setdefault("norm",
                                                             plain(g, m))
    try:
        probe.update(tro, torch.from_numpy(last_value), perms=perms)
    finally:
        tppo.clip_by_global_norm_ = plain
    assert (float(seen["norm"]) < 0.5) == (side == "under"), seen
    jstate, _ = jagent.update(
        jstate, {k: jnp.asarray(v) for k, v in ro.items()},
        jnp.asarray(last_value), jax.random.PRNGKey(0))
    tagent.update(tro, torch.from_numpy(last_value), perms=perms)
    assert_states_close(tagent, jstate, f"gradient norm {side} 0.5")


def test_config_defaults_match_jax():
    j, t = jppo.PPOConfig(), tppo.PPOConfig()
    for f in ("lr", "n_steps", "batch_size", "n_epochs", "gamma", "gae_lambda",
              "clip_range", "ent_coef", "vf_coef", "max_grad_norm"):
        assert getattr(j, f) == getattr(t, f), f
    agent = tppo.PPO()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            agent.init()
    st = agent.init(seed=0, obs_res=RES, device="cpu")
    assert st.opt.defaults["eps"] == 1e-5 and st.opt.defaults["lr"] == 3e-4
    assert st.net.torso.compute_dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the committed checkpoint
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt_tree():
    return ocp.PyTreeCheckpointer().restore(CKPT)


def _trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _trees_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_committed_checkpoint_carries_across_and_back(ckpt_tree):
    """``artifacts/ppo1024_ckpt/model_50003968`` (1526 updates of the
    1024-env recipe): the port's network gives the JAX network's outputs on
    seeded frames (atol 1e-4), its Adam state arrives whole, and the way
    back returns the checkpoint's tree bit for bit."""
    tagent = _torch_agent(ckpt_tree, res=64)
    obs = np.random.default_rng(0).integers(0, 256, (16, 9, 64, 64),
                                            dtype=np.uint8)
    net = jpol.GaussianActorCritic(compute_dtype=jnp.float32)
    jmu, jls, jv = net.apply(ckpt_tree["params"], jnp.asarray(obs))
    with torch.no_grad():
        mu, log_std, v = tagent.state.net(torch.from_numpy(obs))
    assert np.ptp(np.asarray(jmu), axis=0).min() > 1e-3
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=1e-4, rtol=0)
    np.testing.assert_allclose(log_std.detach().numpy(), np.asarray(jls), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-4, rtol=1e-5)
    count, mu_tree, _ = convert._adam_fields(ckpt_tree["opt"])
    assert tagent.state.step == int(ckpt_tree["step"]) == 1526
    assert tagent.export_state()["opt"]["step"] == int(count) > 0
    s = tagent.state.opt.state[tagent.state.net.log_std]
    np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                  mu_tree["params"]["log_std"])
    back = convert.ppo_state_from_torch(tagent.export_state(), 64)
    _trees_equal(back, ckpt_tree)
