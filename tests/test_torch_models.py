"""The port's networks against the JAX package's on the CPU: the same
weights (carried across by ``models/convert.py``) and the same inputs, made
from a seed with numpy, at f32 on both sides.

Tolerances: network outputs atol 1e-4 / rtol 1e-5; the closed-form action
and Gaussian helpers 1e-6; ``sample_squashed`` with JAX's own noise 1e-5;
the bf16 torso within 5e-2 of the f32 one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.models import cnn as jcnn
from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu_torch.models import cnn as tcnn
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.models import policies as tpol

torch.set_num_threads(2)
ATOL, RTOL = 1e-4, 1e-5
B = 6


def _obs(res, seed=0, channels=9):
    return np.random.default_rng(seed).integers(
        0, 256, (B, channels, res, res), dtype=np.uint8)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _carry(jparams, tmodule, res):
    """Load the JAX parameters into the torch module (strict)."""
    tmodule.load_state_dict(convert.params_to_torch(_np_tree(jparams), res))
    return tmodule.eval()


def _close(t, j, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=atol, rtol=rtol)


def test_same_padding_is_xlas():
    # a 20-pixel input: conv1 (8/4) pads 2/2, conv2 sees 5 pixels and pads
    # 1/2 (uneven), conv3 pads 1/1
    assert tcnn.same_padding(20, 8, 4) == (2, 2)
    assert tcnn.same_padding(5, 4, 2) == (1, 2)
    assert tcnn.same_padding(3, 3, 1) == (1, 1)
    assert tcnn.same_padding(16, 8, 4) == (2, 2)
    assert tcnn.same_padding(4, 4, 2) == (1, 1)
    assert [tcnn.conv_out_res(r) for r in (64, 36, 32, 20, 16)] == [4, 1, 4, 3, 2]


@pytest.mark.parametrize("res", [64, 32, 20, 16])
def test_nature_cnn_matches_jax(res):
    """VALID at 64; SAME at 32, 20 (uneven padding before conv2) and 16."""
    obs = _obs(res, seed=res)
    jm = jcnn.NatureCNN(compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(res), jnp.asarray(obs))
    tm = _carry(params, tcnn.NatureCNN(9, obs_res=res,
                                       compute_dtype=torch.float32), res)
    out = tm(torch.from_numpy(obs))
    assert out.dtype == torch.float32 and out.shape == (B, 512)
    _close(out, jm.apply(params, jnp.asarray(obs)))


@pytest.mark.parametrize("res", [64, 20])
def test_squashed_gaussian_actor_matches_jax(res):
    obs = _obs(res, seed=1)
    jm = jpol.SquashedGaussianActor(compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(obs))
    tm = _carry(params, tpol.SquashedGaussianActor(
        obs_res=res, compute_dtype=torch.float32), res)
    mu, log_std = tm(torch.from_numpy(obs))
    jmu, jls = jm.apply(params, jnp.asarray(obs))
    _close(mu, jmu)
    _close(log_std, jls)


def test_log_std_is_clipped():
    tm = tpol.SquashedGaussianActor(compute_dtype=torch.float32)
    with torch.no_grad():
        tm.log_std.bias.copy_(torch.tensor([50.0, -50.0]))
    _, log_std = tm(torch.from_numpy(_obs(64)))
    assert torch.equal(log_std, torch.tensor([[2.0, -20.0]]).repeat(B, 1))


@pytest.mark.parametrize("res", [64, 16])
def test_double_q_critic_matches_jax(res):
    obs = _obs(res, seed=2)
    act = np.random.default_rng(2).uniform(-1, 1, (B, 2)).astype(np.float32)
    jm = jpol.DoubleQCritic(compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(obs), jnp.asarray(act))
    tm = _carry(params, tpol.DoubleQCritic(obs_res=res,
                                           compute_dtype=torch.float32), res)
    q1, q2 = tm(torch.from_numpy(obs), torch.from_numpy(act))
    j1, j2 = jm.apply(params, jnp.asarray(obs), jnp.asarray(act))
    _close(q1, j1)
    _close(q2, j2)
    # two torsos, not one shared
    assert not np.allclose(q1.detach().numpy(), q2.detach().numpy())


def test_deterministic_actor_matches_jax():
    obs = _obs(64, seed=3)
    jm = jpol.DeterministicActor(compute_dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(obs))
    tm = _carry(params, tpol.DeterministicActor(compute_dtype=torch.float32),
                64)
    _close(tm(torch.from_numpy(obs)), jm.apply(params, jnp.asarray(obs)))


def test_gaussian_actor_critic_matches_jax():
    obs = _obs(64, seed=4)
    jm = jpol.GaussianActorCritic(compute_dtype=jnp.float32)
    params = _np_tree(jm.init(jax.random.PRNGKey(4), jnp.asarray(obs)))
    params["params"]["log_std"] = np.array([-0.3, 0.2], np.float32)
    tm = _carry(params, tpol.GaussianActorCritic(compute_dtype=torch.float32),
                64)
    mu, log_std, value = tm(torch.from_numpy(obs))
    jmu, jls, jv = jm.apply(params, jnp.asarray(obs))
    _close(mu, jmu)
    _close(log_std, jls)
    _close(value, jv)
    assert log_std.shape == mu.shape == (B, 2) and value.shape == (B,)


def test_gaussian_actor_critic_init():
    """Orthogonal heads at gains 0.01 and 1.0, zero biases and log-std."""
    tm = tpol.GaussianActorCritic(compute_dtype=torch.float32)
    w = tm.mu.weight.detach()
    np.testing.assert_allclose((w @ w.T).numpy(), 1e-4 * np.eye(2), atol=1e-8)
    v = tm.value.weight.detach()
    np.testing.assert_allclose((v @ v.T).numpy(), [[1.0]], atol=1e-5)
    assert not tm.mu.bias.any() and not tm.value.bias.any()
    assert not tm.log_std.any()


def test_action_scaling_matches_jax():
    a = np.random.default_rng(5).uniform(-1.6, 1.6, (64, 2)).astype(np.float32)
    t = torch.from_numpy(a)
    _close(tpol.scale_action(t), jpol.scale_action(jnp.asarray(a)),
           atol=1e-6, rtol=0)
    _close(tpol.unscale_action(t), jpol.unscale_action(jnp.asarray(a)),
           atol=1e-6, rtol=0)
    # clips first: raw Gaussian samples outside (-1, 1) land on the box
    box = tpol.scale_action(torch.tensor([[-3.0, 3.0]]))
    assert torch.equal(box, torch.tensor([[-1.0, 0.3]]))
    inside = torch.from_numpy(a).clamp(-1, 1)
    _close(tpol.unscale_action(tpol.scale_action(inside)), inside.numpy(),
           atol=1e-6, rtol=0)


def test_gaussian_log_prob_and_entropy_match_jax():
    rng = np.random.default_rng(6)
    mu = rng.normal(size=(32, 2)).astype(np.float32)
    ls = rng.uniform(-3, 1, (32, 2)).astype(np.float32)
    act = rng.normal(size=(32, 2)).astype(np.float32)
    _close(tpol.gaussian_log_prob(*map(torch.from_numpy, (mu, ls, act))),
           jpol.gaussian_log_prob(*map(jnp.asarray, (mu, ls, act))),
           atol=1e-6, rtol=1e-6)
    _close(tpol.gaussian_entropy(torch.from_numpy(ls)),
           jpol.gaussian_entropy(jnp.asarray(ls)), atol=1e-6, rtol=0)


def test_sample_squashed_matches_jax_on_its_noise():
    rng = np.random.default_rng(7)
    mu = rng.normal(size=(64, 2)).astype(np.float32) * 2.0
    mu[:8] = rng.choice([-1.0, 1.0], (8, 2)) * rng.uniform(10.5, 30.0, (8, 2))
    ls = rng.uniform(-5, 1, (64, 2)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    noise = np.array(jax.random.normal(key, mu.shape))
    ja, jlp = jpol.sample_squashed(jnp.asarray(mu), jnp.asarray(ls), key)
    a, lp = tpol.sample_squashed(torch.from_numpy(mu), torch.from_numpy(ls),
                                 noise=torch.from_numpy(noise))
    assert (np.abs(mu[:8] + np.exp(ls[:8]) * noise[:8]) > 10).all()
    _close(a, ja, atol=1e-5, rtol=1e-5)
    _close(lp, jlp, atol=1e-5, rtol=1e-5)
    assert torch.isfinite(lp).all()


def test_sample_squashed_draws_from_the_generator():
    mu, ls = torch.zeros(5, 2), torch.zeros(5, 2)
    a1, lp1 = tpol.sample_squashed(mu, ls, torch.Generator().manual_seed(3))
    a2, lp2 = tpol.sample_squashed(mu, ls, torch.Generator().manual_seed(3))
    want = torch.randn(5, 2, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a1, a2) and torch.equal(lp1, lp2)
    assert torch.equal(a1, torch.tanh(want))


def test_bf16_torso_is_close_to_f32():
    obs = torch.from_numpy(_obs(64, seed=8))
    f32 = tpol.SquashedGaussianActor(compute_dtype=torch.float32).eval()
    bf16 = tpol.SquashedGaussianActor().eval()          # the default dtype
    assert bf16.torso.compute_dtype == torch.bfloat16
    bf16.load_state_dict(f32.state_dict())
    with torch.no_grad():
        h32, h16 = f32.torso(obs), bf16.torso(obs)
        mu32, _ = f32(obs)
        mu16, _ = bf16(obs)
    assert h16.dtype == torch.float32 and mu16.dtype == torch.float32
    np.testing.assert_allclose(h16.numpy(), h32.numpy(), atol=5e-2)
    np.testing.assert_allclose(mu16.numpy(), mu32.numpy(), atol=5e-2)
    assert not torch.equal(h16, h32)
    # parameters stay f32 under the bf16 torso
    assert all(p.dtype == torch.float32 for p in bf16.parameters())


def test_fresh_layers_start_like_flax_layers():
    """LeCun-normal kernels (variance 1 / fan_in) and zero biases, as
    ``flax.linen``'s Conv and Dense start."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        m = tpol.DoubleQCritic(compute_dtype=torch.float32)
    for name, layer in (("q1_torso.conv2", m.q1_torso.conv2),
                        ("q2_torso.fc", m.q2_torso.fc), ("q1_h", m.q1_h)):
        w = layer.weight.detach()
        fan_in = w[0].numel()
        assert float(w.std()) == pytest.approx(fan_in ** -0.5, rel=0.05), name
        assert float(w.abs().max()) <= 2.0 * fan_in ** -0.5 / 0.8796 + 1e-6
        assert not layer.bias.any(), name
