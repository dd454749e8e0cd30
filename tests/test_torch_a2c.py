"""The port's A2C (``rl/a2c.py``) against the JAX package's: one update on
the whole rollout from carried-over weights (parameters, Adam moments, step
counts and the four metrics at the tolerance ``tests/test_torch_ppo.py``
states), with rewards at two scales so that the gradient's global norm lies
under and over ``max_grad_norm``; acting; and the defaults that differ from
PPO's (lr 7e-4, Adam's default eps, no advantage normalisation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_ppo import E, RES, T, _rollout, _tree_of, assert_states_close
from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu.rl import a2c as ja2c
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.rl import a2c as ta2c
from torchdriveenv_tpu_torch.rl import ppo as tppo

torch.set_num_threads(2)


def _both(**cfg):
    jagent = ja2c.A2C(ja2c.A2CConfig(**cfg))
    jagent.net = jpol.GaussianActorCritic(compute_dtype=jnp.float32)
    jstate = jagent.init(jax.random.PRNGKey(0), obs_res=RES)
    tagent = ta2c.A2C(ta2c.A2CConfig(**cfg), compute_dtype=torch.float32)
    tagent.init(seed=1, obs_res=RES, device="cpu")
    tagent.load_state(convert.a2c_state_to_torch(_tree_of(jstate), RES))
    return jagent, jstate, tagent


@pytest.mark.parametrize("reward_scale", [0.01, 1.0])
def test_update_matches_jax(reward_scale):
    jagent, jstate, tagent = _both()
    assert_states_close(tagent, jstate, "start")
    ro, last_value = _rollout(30, jagent, jstate, reward_scale=reward_scale)
    tro = {k: torch.from_numpy(v) for k, v in ro.items()}

    seen = {}
    plain = tppo.clip_by_global_norm_
    tppo.clip_by_global_norm_ = lambda g, m: seen.setdefault("norm",
                                                             plain(g, m))
    try:
        tm = tagent.update(tro, torch.from_numpy(last_value))
    finally:
        tppo.clip_by_global_norm_ = plain
    # the small rewards leave the gradient under the clip, the others over
    assert (float(seen["norm"]) < 0.5) == (reward_scale < 1.0), seen

    jstate, jm = jax.jit(jagent.update)(
        jstate, {k: jnp.asarray(v) for k, v in ro.items()},
        jnp.asarray(last_value), jax.random.PRNGKey(0))
    assert sorted(tm) == sorted(jm) == sorted(ta2c.A2C.metric_names)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
        assert not tm[k].requires_grad
    assert_states_close(tagent, jstate, "one update")
    assert tagent.state.step == 1
    assert tagent.export_state()["opt"]["step"] == 1      # one pass, one step
    assert all(p.grad is None for p in tagent.state.net.parameters())


def test_advantages_are_not_normalised_and_carry_no_gradient():
    """The policy loss is -mean(adv * logp) with the raw GAE advantages: by
    hand from the port's own GAE."""
    jagent, jstate, tagent = _both(ent_coef=0.0, vf_coef=0.0)
    ro, last_value = _rollout(31, jagent, jstate, reward_scale=3.0)
    tro = {k: torch.from_numpy(v) for k, v in ro.items()}
    advs, _ = tppo.compute_gae(tro["reward"], tro["value"], tro["done"],
                               torch.from_numpy(last_value), 0.99, 0.95)
    with torch.no_grad():
        mu, log_std, _ = tagent.state.net(tro["obs"].reshape(T * E, 9, RES, RES))
        logp = tppo.gaussian_log_prob(mu, log_std,
                                      tro["action"].reshape(T * E, 2))
    want = -(advs.reshape(-1) * logp).mean()
    tm = tagent.update(tro, torch.from_numpy(last_value))
    assert float(tm["pg_loss"]) == pytest.approx(float(want), rel=1e-5)
    assert float(tm["loss"]) == pytest.approx(float(want), rel=1e-5)
    assert float(advs.std()) > 2.0          # far from unit variance


def test_acting_and_defaults():
    j, t = ja2c.A2CConfig(), ta2c.A2CConfig()
    for f in ("lr", "n_steps", "gamma", "gae_lambda", "ent_coef", "vf_coef",
              "max_grad_norm"):
        assert getattr(j, f) == getattr(t, f), f
    jagent, jstate, tagent = _both()
    assert tagent.state.opt.defaults["eps"] == 1e-8
    assert tagent.state.opt.defaults["lr"] == 7e-4
    obs = np.random.default_rng(2).integers(0, 256, (E, 9, RES, RES),
                                            dtype=np.uint8)
    key = jax.random.PRNGKey(4)
    ja, jlogp, jv = jagent.select_action(jstate, jnp.asarray(obs), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (E, 2))))
    ta, tlogp, tv = tagent.select_action(torch.from_numpy(obs), noise=noise)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-5)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_allclose(
        tagent.value(torch.from_numpy(obs)).numpy(),
        np.asarray(jagent.value(jstate, jnp.asarray(obs))), atol=1e-5)
    # the state carries back to the JAX layout, chained optimizer included
    back = convert.a2c_state_from_torch(tagent.export_state(), RES)
    assert back["opt"][0] is None and int(back["opt"][1][0]["count"]) == 0
