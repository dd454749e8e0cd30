"""The port's SAC update against the JAX package's: both sides start from
one state (fresh, or the committed deliverable's restored ``SACState`` with
its non-zero Adam moments), take the same batches and the same two noise
draws, and must agree after each of three consecutive updates.

Tolerances: the seven metrics rtol 1e-4 / atol 1e-5; Adam's counters
exact; every parameter, the targets, ``log_alpha`` and Adam's moments atol
2e-5 plus 1e-5 of the tensor's largest magnitude (the deliverable's critic
moments reach 1e6, where an f32 ulp is 0.06). Two effects of f32 arithmetic
no tolerance covers are handled by name:
  - Adam's step is lr * m / (sqrt(v) + 1e-8): on an element whose gradient
    is within rounding of zero, rounding noise moves the step by a fraction
    of lr. At most 4 elements of a tensor (or 1e-5 of it) may exceed the
    tolerance, by no more than 100 times.
  - a ReLU whose input lies within rounding of zero passes its gradient on
    one side and blocks it on the other, which changes a whole channel's
    gradient. The batches' seeds below were chosen so that no such flip
    occurs in these runs.
Both sides compute in f32.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu.rl import sac as jsac
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.models import policies as tpol
from torchdriveenv_tpu_torch.rl import sac as tsac

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "deliverable_sac_stage1_model_2000384")
B, RES = 8, 64
STATE_KEYS = ("actor_params", "critic_params", "target_critic_params",
              "log_alpha", "step", "actor_opt", "critic_opt", "alpha_opt")
# seed of the first batch of a run from the deliverable's state, per case
DELIVERABLE_BATCH_SEED = {"default": 200, "fixed_alpha": 100, "bc_coef": 300,
                          "actor_delay": 200}
ATOL, SCALE_RTOL = 2e-5, 1e-5
CASES = {
    "default": dict(),
    "fixed_alpha": dict(fixed_alpha=0.02),
    "bc_coef": dict(bc_coef=50.0),
    "actor_delay": dict(actor_delay_updates=2),
}


def _jax_agent(**cfg):
    agent = jsac.SAC(jsac.SACConfig(**cfg))
    agent.actor = jpol.SquashedGaussianActor(compute_dtype=jnp.float32)
    agent.critic = jpol.DoubleQCritic(compute_dtype=jnp.float32)
    return agent


def _torch_agent(tree, **cfg):
    agent = tsac.SAC(tsac.SACConfig(**cfg), compute_dtype=torch.float32)
    agent.init(seed=1, obs_res=RES, device="cpu")
    agent.load_state(convert.sac_state_to_torch(tree, RES))
    return agent


def _tree_of(jstate):
    return {k: jax.tree.map(np.asarray, getattr(jstate, k))
            for k in STATE_KEYS}


@pytest.fixture(scope="module")
def deliverable_tree():
    return ocp.PyTreeCheckpointer().restore(CKPT)


def _jax_state(tree):
    """A live ``SACState`` from a numpy tree (restored, or ``_tree_of``)."""
    def as_j(t):
        return jax.tree.map(jnp.asarray, t)

    def opt(o):
        count, mu, nu = convert._adam_fields(o)
        return (optax.ScaleByAdamState(count=jnp.asarray(count), mu=as_j(mu),
                                       nu=as_j(nu)), optax.EmptyState())

    return jsac.SACState(
        actor_params=as_j(tree["actor_params"]),
        critic_params=as_j(tree["critic_params"]),
        target_critic_params=as_j(tree["target_critic_params"]),
        log_alpha=jnp.asarray(tree["log_alpha"]),
        actor_opt=opt(tree["actor_opt"]), critic_opt=opt(tree["critic_opt"]),
        alpha_opt=opt(tree["alpha_opt"]), step=jnp.asarray(tree["step"]))


def _batch(seed):
    rng = np.random.default_rng(seed)
    return dict(
        obs=rng.integers(0, 256, (B, 9, RES, RES), dtype=np.uint8),
        next_obs=rng.integers(0, 256, (B, 9, RES, RES), dtype=np.uint8),
        # some demo actions saturate at the box, as the scripted driver's do
        action=np.clip(rng.uniform(-1.3, 1.3, (B, 2)), -1, 1).astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        discount_mask=(rng.random(B) > 0.25).astype(np.float32),
        done=rng.random(B) < 0.25,
        is_demo=np.arange(B) % 2 == 0)


def _torch_batch(seed):
    """``_batch(seed)`` as torch tensors, with the rows' places in the batch
    (``pos``) that ``buffer.sample`` returns beside them."""
    batch = {k: torch.from_numpy(v) for k, v in _batch(seed).items()}
    batch["pos"] = torch.arange(B)
    return batch


def _noise(key):
    """The draws ``jsac.SAC.update`` makes from ``key``."""
    k_next, k_pi = jax.random.split(key)
    return tuple(torch.from_numpy(np.array(jax.random.normal(k, (B, 2))))
                 for k in (k_next, k_pi))


def _assert_close(got, want, name, atol=ATOL):
    """The tolerance of the module docstring on one tensor."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    diff = (got - want).abs()
    tol = atol + SCALE_RTOL * float(want.abs().max())
    n_over = int((diff > tol).sum())
    assert n_over <= max(4, got.numel() * 1e-5), (
        f"{name}: {n_over} of {got.numel()} elements over {tol:.3g}, "
        f"max {float(diff.max()):.3g}")
    assert float(diff.max()) <= 100 * tol, (
        f"{name}: max difference {float(diff.max()):.3g} over 100 x {tol:.3g}")


def _assert_states_close(tagent, jstate, where, param_atol=ATOL):
    want = convert.sac_state_to_torch(_tree_of(jstate), RES)
    got = tagent.export_state()
    assert got["step"] == want["step"], where
    _assert_close(got["log_alpha"], want["log_alpha"], f"{where}: log_alpha",
                  param_atol)
    for net in ("actor", "critic", "target_critic"):
        assert sorted(got[net]) == sorted(want[net])
        for k in want[net]:
            _assert_close(got[net][k], want[net][k], f"{where}: {net}.{k}",
                          param_atol)
    for opt in convert.SAC_OPT_KEYS:
        assert got[opt]["step"] == want[opt]["step"], (where, opt)
        for moment in ("exp_avg", "exp_avg_sq"):
            for k in want[opt][moment]:
                _assert_close(got[opt][moment][k], want[opt][moment][k],
                              f"{where}: {opt}.{moment}.{k}")


def _run_both(tree, cfg, n_updates=3, batch_seed=0):
    """Yield (update number, torch agent, jax state, torch metrics, jax
    metrics) after each update of both sides."""
    jagent, tagent = _jax_agent(**cfg), _torch_agent(tree, **cfg)
    jstate = _jax_state(tree)
    _assert_states_close(tagent, jstate, "start")
    for u in range(n_updates):
        batch, key = _batch(batch_seed + u), jax.random.PRNGKey(10 + u)
        jstate, jm = jagent.update(
            jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        tm = tagent.update(_torch_batch(batch_seed + u), noise=_noise(key))
        yield u + 1, tagent, jstate, tm, jm


def _check_run(tree, cfg, batch_seed=0):
    for u, tagent, jstate, tm, jm in _run_both(tree, cfg,
                                               batch_seed=batch_seed):
        assert sorted(tm) == sorted(jm) == sorted(tsac.SAC.metric_names)
        for k in jm:
            np.testing.assert_allclose(
                float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-5,
                err_msg=f"update {u}: metric {k}")
        _assert_states_close(tagent, jstate, f"update {u}")
        yield u, tagent, jstate


def _fresh_tree():
    return _tree_of(_jax_agent().init(jax.random.PRNGKey(0), obs_res=RES))


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax_from_a_fresh_state(case):
    tree, cfg = _fresh_tree(), CASES[case]
    before = None
    for u, tagent, jstate in _check_run(tree, cfg):
        st = tagent.state
        if case == "fixed_alpha":
            assert float(st.log_alpha.detach()) == 0.0      # never moves
            # ... while its Adam state advances, as optax's does
            assert int(jstate.alpha_opt[0].count) == u
        if case == "actor_delay":
            frozen = u <= 2
            a_step = tagent.export_state()["actor_opt"]["step"]
            assert a_step == (0 if frozen else u - 2)
            assert tagent.export_state()["alpha_opt"]["step"] == a_step
            now = copy.deepcopy(st.actor.state_dict())
            if before is not None:
                same = all(torch.equal(now[k], before[k]) for k in now)
                assert same == frozen, f"update {u}"
            before = now
            assert (float(st.log_alpha.detach()) == 0.0) == frozen


@pytest.mark.parametrize("case", list(CASES))
def test_update_matches_jax_from_the_deliverable_state(deliverable_tree, case):
    """The restored state: Adam counts in the hundreds of thousands and
    non-zero moments on every parameter."""
    cfg = dict(CASES[case])
    step0 = int(deliverable_tree["step"])
    if case == "actor_delay":
        cfg["actor_delay_updates"] = step0 + 2
    a_count0 = int(deliverable_tree["actor_opt"][0]["count"])
    for u, tagent, jstate in _check_run(deliverable_tree, cfg,
                                        DELIVERABLE_BATCH_SEED[case]):
        assert tagent.state.step == step0 + u
        if case == "actor_delay":
            want = a_count0 + max(u - 2, 0)
            assert tagent.export_state()["actor_opt"]["step"] == want
            assert int(jstate.actor_opt[0].count) == want


def test_gradients_are_taken_before_any_step():
    """With a large learning rate the critic moves far in one step. The
    actor's first Adam moment (0.1 x its gradient, from zero moments) must be
    the gradient through the critic as it was, not as it became; and the
    critic's must hold the critic loss's gradient alone."""
    tree = _fresh_tree()
    cfg = dict(lr=0.05)
    tagent = _torch_agent(tree, **cfg)
    pre_actor = copy.deepcopy(tagent.state.actor)
    pre_critic = copy.deepcopy(tagent.state.critic)
    pre_target = copy.deepcopy(tagent.state.target_critic)
    batch = _torch_batch(0)
    key = jax.random.PRNGKey(10)
    n_next, n_pi = _noise(key)
    tagent.update(batch, noise=(n_next, n_pi))
    post_critic = tagent.state.critic

    def actor_grad(critic):
        actor = copy.deepcopy(pre_actor)
        mu, log_std = actor(batch["obs"])
        a, logp = tpol.sample_squashed(mu, log_std, noise=n_pi)
        q = torch.minimum(*critic(batch["obs"], a))
        loss = (1.0 * logp - q).mean()          # alpha = exp(0)
        return dict(zip((n for n, _ in actor.named_parameters()),
                        torch.autograd.grad(loss, list(actor.parameters()))))

    g_pre, g_post = actor_grad(pre_critic), actor_grad(post_critic)
    moments = tagent.export_state()["actor_opt"]["exp_avg"]
    far = 0.0
    for k, m in moments.items():
        np.testing.assert_allclose(m.numpy(), 0.1 * g_pre[k].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
        far = max(far, float((g_pre[k] - g_post[k]).abs().max()))
    assert far > 1e-2, "the moved critic gives another actor gradient"

    # the critic's step saw the critic loss only
    with torch.no_grad():
        mu_n, ls_n = pre_actor(batch["next_obs"])
        next_a, next_logp = tpol.sample_squashed(mu_n, ls_n, noise=n_next)
        tq = torch.minimum(*pre_target(batch["next_obs"], next_a))
        target_q = batch["reward"] + 0.99 * batch["discount_mask"] * (
            tq - next_logp)
    critic = copy.deepcopy(pre_critic)
    q1, q2 = critic(batch["obs"], batch["action"])
    loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
    grads = torch.autograd.grad(loss, list(critic.parameters()))
    c_moments = tagent.export_state()["critic_opt"]["exp_avg"]
    for (k, _), g in zip(critic.named_parameters(), grads):
        np.testing.assert_allclose(c_moments[k].numpy(), 0.1 * g.numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=k)
    # nothing is left on any .grad
    st = tagent.state
    assert all(p.grad is None for m in (st.actor, st.critic, st.target_critic)
               for p in m.parameters())
    assert st.log_alpha.grad is None

    # and the JAX package orders it the same way
    jagent = _jax_agent(**cfg)
    jstate, _ = jagent.update(
        _jax_state(tree), {k: jnp.asarray(v) for k, v in _batch(0).items()},
        key)
    # a first Adam step moves every element by about lr: the parameters'
    # tolerance scales with it
    _assert_states_close(tagent, jstate, "lr 0.05, one update",
                         param_atol=ATOL * 0.05 / 3e-4)


def test_select_action():
    tagent = _torch_agent(_fresh_tree())
    obs = torch.from_numpy(_batch(3)["obs"])
    det = tagent.select_action(obs, deterministic=True)
    mu, log_std = tagent.state.actor(obs)
    assert torch.equal(det, torch.tanh(mu)) and not det.requires_grad
    noise = torch.randn(B, 2, generator=torch.Generator().manual_seed(0))
    a = tagent.select_action(obs, torch.Generator().manual_seed(0))
    assert torch.equal(a, torch.tanh(mu + torch.exp(log_std) * noise).detach())
    assert torch.equal(a, tagent.select_action(obs, noise=noise))


def test_config_defaults_match_jax():
    j, t = jsac.SACConfig(), tsac.SACConfig()
    for f in ("lr", "gamma", "tau", "batch_size", "buffer_size",
              "learning_starts", "target_entropy", "init_alpha",
              "actor_delay_updates", "fixed_alpha", "bc_coef"):
        assert getattr(j, f) == getattr(t, f), f
    la, lp = torch.tensor(0.3), torch.tensor(-1.7)
    assert float(tsac.alpha_loss_sb3(la, lp, -2.0)) == pytest.approx(
        float(jsac.alpha_loss_sb3(jnp.asarray(0.3), jnp.asarray(-1.7), -2.0)))


def test_init_needs_a_device_by_name():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsac.SAC().init()
    a = tsac.SAC(compute_dtype=torch.float32).init(seed=3, device="cpu")
    b = tsac.SAC(compute_dtype=torch.float32).init(seed=3, device="cpu")
    for p, q in zip(a.actor.parameters(), b.actor.parameters()):
        assert torch.equal(p, q)
    for p, q in zip(a.critic.parameters(), a.target_critic.parameters()):
        assert torch.equal(p, q) and not q.requires_grad
