"""The port's GRU NPC policy (``npc/policy_net.py``) against the JAX
package's: the GRU layout, the features, the actions and next hidden state
of the shipped weights, the parked and never-reverse rules, and the
distillation loss and gradients on JAX's own scenes; a short port-side
distillation lowers the imitation error.

The JAX side runs un-jitted under ``vmap``. Floats are held to 1e-5: the
features project positions on cos/sin of each heading, which differ by an
ulp between XLA's CPU library and torch's, and XLA:CPU evaluates the
leader search's einsums as fused multiply-adds. The heading error is folded
at |herr| = pi/2 (a line field), where an ulp flips the sign of its sine:
agents within 1e-5 of the fold are counted, left out of the comparison,
and the count is asserted (none in these scenes).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env import core as jcore
from torchdriveenv_tpu.env.batched import make_env_fns as jmake_env_fns
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.npc import policy_net as jpn
from torchdriveenv_tpu.npc import route_follow as jrf
from torchdriveenv_tpu_torch.config import EnvConfig as TEnvConfig
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.maps.arrays import sample_npc_field
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.npc import policy_net as tpn
from torchdriveenv_tpu_torch.npc import route_follow as trf

torch.set_num_threads(2)
TOL = dict(atol=1e-5, rtol=1e-5)
FOLD_EPS = 1e-5


@pytest.fixture(scope="module")
def jassets():
    return jload("val")


@pytest.fixture(scope="module")
def tassets():
    return tload("val", device="cpu")


@pytest.fixture(scope="module")
def policy_state(jassets):
    """A JAX policy-mode reset of 4 val envs plus 6 jitted steps: NPCs moved
    by the GRU, hidden states that are not zero."""
    reset_fn, step_fn = jmake_env_fns(JEnvConfig(npc_mode="policy"), jassets,
                                      render=False)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4, dtype=jnp.uint32) + 21)
    st, _ = jax.jit(reset_fn)(keys)
    step = jax.jit(step_fn)
    actions = jnp.tile(jnp.array([[0.3, 0.0]]), (4, 1))
    for _ in range(6):
        st = step(st, actions).state
    st = jax.tree.map(np.array, st)
    assert np.abs(st.npc_hidden).max() > 0.1
    return st


def _t(st):
    return (st.time0 + st.step_idx.astype(np.float32) * np.float32(0.1)
            ).astype(np.float32)


def _args(st):
    return (st.town, _t(st), st.agent_states, st.agent_attrs, st.present,
            st.npc_target_speed)


def _at_fold(tassets, town, states):
    """(B, A) bool: the agent's unfolded heading error (port side) is within
    FOLD_EPS of +-pi/2."""
    st = torch.from_numpy(states)
    psi, v = st[..., 2], st[..., 3]
    look = torch.clamp(v * 0.6, min=3.0)
    probe = torch.stack(
        [st[..., 0] + torch.cos(psi) * look - torch.sin(psi) * trf.LANE_OFFSET,
         st[..., 1] + torch.sin(psi) * look + torch.cos(psi) * trf.LANE_OFFSET],
        dim=-1)
    dir_tgt, _, _ = sample_npc_field(tassets.maps, torch.from_numpy(town), probe)
    herr = trf._wrap(dir_tgt - psi)
    return (torch.abs(torch.abs(herr) - math.pi / 2) < FOLD_EPS).numpy()


def _jax_params():
    return jax.tree.map(jnp.asarray, jpn.default_params())


def _close_off_fold(got, want, keep):
    np.testing.assert_allclose(np.asarray(got)[keep], np.asarray(want)[keep],
                               **TOL)


# --------------------------------------------------------------------------
# the GRU
# --------------------------------------------------------------------------


def test_gru_cell_is_flax_gru():
    """Random weights and inputs through Flax's ``NpcGRU`` and the port's:
    the gate equations and the bias layout (none on hr / hz) agree."""
    params = jpn.init_params(jax.random.PRNGKey(4))
    rng = np.random.default_rng(0)
    h = rng.normal(size=(64, tpn.HIDDEN)).astype(np.float32)
    x = rng.normal(size=(64, tpn.N_FEATURES)).astype(np.float32)
    jh, ja = jax.vmap(lambda hh, xx: jpn.NpcGRU().apply(params, hh, xx))(h, x)
    policy = tpn.NpcGRU()
    policy.load_state_dict(convert.npc_params_to_torch(
        jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        th, ta = policy(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **TOL)
    assert policy.GRUCell_0.hr.bias is None and policy.GRUCell_0.hz.bias is None
    assert np.abs(np.asarray(ja)).max() > 0.1


def test_shipped_policy_is_the_jax_default():
    shipped = tpn.default_params("cpu")
    assert shipped is tpn.default_params(torch.device("cpu"))   # cached
    assert not any(p.requires_grad for p in shipped.parameters())
    want = convert.npc_params_to_torch(jpn.default_params())
    got = shipped.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_a_missing_file_is_an_error(tmp_path):
    with pytest.raises(FileNotFoundError):
        tpn.load_npc_policy(str(tmp_path / "none.npz"), device="cpu")


def test_init_policy_is_seeded():
    a = tpn.init_policy(torch.Generator().manual_seed(1), "cpu")
    b = tpn.init_policy(torch.Generator().manual_seed(1), "cpu")
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k]), k
    w = a.GRUCell_0.hr.weight.detach()
    torch.testing.assert_close(w @ w.T, torch.eye(tpn.HIDDEN), atol=1e-5,
                               rtol=0)
    assert not a.GRUCell_0.ir.bias.detach().any()


# --------------------------------------------------------------------------
# features and actions against the JAX package
# --------------------------------------------------------------------------


def test_features(jassets, tassets, policy_state):
    st = policy_state
    want = np.asarray(jax.vmap(functools.partial(jpn._features, jassets.maps))(
        *_args(st)))
    got = tpn._features(tassets.maps, *map(torch.from_numpy, _args(st)))
    assert got.shape == (4, 96, tpn.N_FEATURES)
    fold = _at_fold(tassets, st.town, st.agent_states)
    assert fold.sum() == 0, f"{fold.sum()} agents at the fold"
    _close_off_fold(got.numpy(), want, ~fold)
    assert (want[..., 5] < 1.0).sum() > 10, "the scene has leaders"
    assert (want[..., 7] < 1.0).sum() > 0, "the scene has red stoplines"


def test_npc_policy_actions_on_a_jax_batch(jassets, tassets, policy_state):
    st = policy_state
    want_a, want_h = jax.vmap(functools.partial(
        jpn.npc_policy_actions, _jax_params(), jassets.maps))(
            *_args(st), st.npc_hidden)
    with torch.no_grad():
        got_a, got_h = tpn.npc_policy_actions(
            tpn.default_params("cpu"), tassets.maps,
            *map(torch.from_numpy, _args(st)), torch.from_numpy(st.npc_hidden))
    keep = ~_at_fold(tassets, st.town, st.agent_states)
    assert keep.all()
    _close_off_fold(got_a.numpy(), want_a, keep)
    _close_off_fold(got_h.numpy(), want_h, keep)
    assert np.abs(np.asarray(want_a)).max() > 0.5


def _synthetic_scene(n=96):
    """``tests/test_npc_policy.py``'s scene: a row of agents at 5 m/s."""
    st = np.zeros((n, 4), np.float32)
    st[:, 3] = 5.0
    st[:, 0] = np.linspace(-50, 50, n, dtype=np.float32)
    attrs = np.ones((n, 3), np.float32) * np.array([4.8, 2.0, 1.4], np.float32)
    present = np.arange(n) < 40
    return st, attrs, present, np.full((n,), 6.0, np.float32)


@pytest.mark.parametrize("target", ["cruise", "parked"])
def test_npc_policy_actions_on_the_synthetic_scene(jassets, tassets, target):
    st, attrs, present, ts = _synthetic_scene()
    if target == "parked":
        ts = np.zeros_like(ts)
    h = np.random.default_rng(2).normal(size=(96, tpn.HIDDEN)).astype(np.float32)
    want_a, want_h = jpn.npc_policy_actions(
        _jax_params(), jassets.maps, jnp.int32(0), jnp.float32(0.0),
        st, attrs, present, ts, h)
    with torch.no_grad():
        got_a, got_h = tpn.npc_policy_actions(
            tpn.default_params("cpu"), tassets.maps,
            torch.zeros(1, dtype=torch.int32), torch.zeros(1),
            *(torch.from_numpy(x)[None] for x in (st, attrs, present, ts, h)))
    keep = ~_at_fold(tassets, np.zeros(1, np.int32), st[None])[0]
    assert keep.all()
    np.testing.assert_allclose(got_a[0].numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(got_h[0].numpy(), np.asarray(want_h), **TOL)
    a = got_a[0].numpy()
    if target == "parked":           # brake toward standstill, go straight
        assert (a[:, 1] == 0.0).all() and (a[:, 0] <= 0.0).all()
        np.testing.assert_array_equal(a[:, 0], np.clip(-4.0 * st[:, 3], -4, 2))
    else:
        assert np.abs(a[:, 1]).max() > 0.0
    assert (np.abs(a[:, 1]) <= trf.STEER_BOUND + 1e-6).all()


def test_nobody_reverses():
    """A policy that always brakes hard: the action floor -v / 0.1 holds,
    and parked agents take the hold rule instead."""
    policy = tpn.NpcGRU()
    with torch.no_grad():
        for p in policy.parameters():
            p.zero_()
        policy.Dense_1.bias.copy_(torch.tensor([-50.0, 0.0]))   # tanh -> -1
    v = torch.tensor([[0.0, 0.05, 0.2, 3.0, 1.0]])
    states = torch.zeros(1, 5, 4)
    states[..., 3] = v
    ts = torch.tensor([[5.0, 5.0, 5.0, 5.0, 0.0]])
    feats = torch.zeros(1, 5, tpn.N_FEATURES)
    with torch.no_grad():
        act, h = tpn.policy_actions(policy, feats,
                                    tpn.init_hidden(1, 5, "cpu"), states, ts)
    np.testing.assert_allclose(act[0, :, 0].numpy(),
                               [0.0, -0.5, -2.0, -4.0, -4.0], rtol=1e-6)
    assert h.shape == (1, 5, tpn.HIDDEN)


# --------------------------------------------------------------------------
# distillation
# --------------------------------------------------------------------------


def _jax_loss(params, maps, st):
    """The loss of ``torchdriveenv_tpu/npc/policy_net.py:distill``."""
    def one(town, tt, s, a, pr, ts):
        target = jrf.npc_actions(maps, town, tt, s, a, pr, ts)
        act, _ = jpn.npc_policy_actions(params, maps, town, tt, s, a, pr, ts,
                                        jpn.init_hidden(s.shape[0]))
        w = pr.astype(jnp.float32)[:, None]
        return jnp.sum(w * (act - target) ** 2) / jnp.maximum(w.sum(), 1.0)
    return jax.vmap(one)(st.town, st.time0, st.agent_states, st.agent_attrs,
                         st.present, st.npc_target_speed).mean()


def test_distill_loss_and_gradients_match_jax(jassets, tassets):
    """One step's loss and gradients on 4 of JAX's fresh scenes, from
    random weights (the shipped ones sit near a minimum), relative to each
    gradient's largest element."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4, dtype=jnp.uint32) + 7)
    st = jax.tree.map(np.array, jax.jit(jax.vmap(
        functools.partial(jcore.reset, JEnvConfig(), jassets)))(keys))
    params = jpn.init_params(jax.random.PRNGKey(3))
    want_loss, want_grad = jax.value_and_grad(_jax_loss)(params, jassets.maps,
                                                         st)
    policy = tpn.NpcGRU()
    policy.load_state_dict(convert.npc_params_to_torch(
        jax.tree.map(np.asarray, params)))
    scene = tcore.EnvState.from_numpy(st, device="cpu")
    fold = _at_fold(tassets, st.town, st.agent_states)
    assert fold.sum() == 0, f"{fold.sum()} agents at the fold"
    loss = tpn.distill_loss(policy, tassets.maps, scene)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    grads = convert.npc_params_from_torch(
        {k: p.grad for k, p in policy.named_parameters()})
    flat_want = jax.tree_util.tree_leaves_with_path(want_grad)
    assert len(flat_want) == 14
    moving = 0
    for path, g in flat_want:
        node = grads
        for k in path:
            node = node[k.key]
        g = np.asarray(g)
        # zero where the zero hidden state (and hn's zero bias) cut the path:
        # the recurrent kernels and the reset gate's input layer
        moving += bool(np.abs(g).max() > 0.0)
        np.testing.assert_allclose(node, g, atol=1e-5 * np.abs(g).max(),
                                   rtol=0, err_msg=str(path))
    assert moving == 9


def test_distill_lowers_the_imitation_error(tassets):
    """A short distillation fits the route follower better than the random
    start (the port's twin of ``tests/test_npc_policy.py:69``)."""
    start = tpn.init_policy(torch.Generator().manual_seed(0), "cpu")
    probe = tcore.reset(TEnvConfig(), tassets, 8,
                        torch.Generator().manual_seed(42))
    with torch.no_grad():
        before = float(tpn.distill_loss(start, tassets.maps, probe))
    trained, last = tpn.distill(
        tassets, steps=30, batch=8, lr=3e-3,
        generator=torch.Generator().manual_seed(1),
        policy=tpn.init_policy(torch.Generator().manual_seed(0), "cpu"))
    with torch.no_grad():
        after = float(tpn.distill_loss(trained, tassets.maps, probe))
    assert math.isfinite(last) and after < before, (before, after)
