"""The port's env core (``reset``, ``step``) against the JAX package.

(a) The 75 golden arrays (5 validation cases x 3 action scripts x 60
    ego-only steps, tools/golden_trajectories.py) at the golden tolerance,
    from the JAX reset states.
(b) Reset parity: the torch reset fed JAX's own random draws (the same
    key splits as ``core.reset``) builds the same state.
(c) Traffic step parity: one step from one state matches field by field;
    a 10-step rollout keeps terminations and presence exact.

Where exactness is asserted the JAX side runs un-jitted. Floats carry a
tolerance because cos/sin/tan/arctan differ by an ulp between XLA's CPU
library and torch's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools.golden_trajectories import SEED, action_sequences, golden_path
from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env import core as jcore
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu_torch.config import EnvConfig as TEnvConfig
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload

torch.set_num_threads(2)
GOLDEN_TOL = dict(atol=1e-4, rtol=1e-5)


@pytest.fixture(scope="module")
def jassets():
    return jload("val")


@pytest.fixture(scope="module")
def tassets():
    return tload("val", device="cpu")


def _np_tree(x):
    return jax.tree.map(np.array, x)


# --------------------------------------------------------------------------
# (a) golden trajectories
# --------------------------------------------------------------------------


def test_golden_trajectories(jassets, tassets):
    jcfg = JEnvConfig(ego_only=True, seed=SEED)
    tcfg = TEnvConfig(ego_only=True, seed=SEED)
    scripts = action_sequences()
    reset = jax.jit(functools.partial(jcore.reset, jcfg, jassets))
    states, acts, names = [], [], []
    for case in range(5):
        st = _np_tree(reset(jax.random.PRNGKey(SEED + case), jnp.asarray(case)))
        for name, a in scripts.items():
            states.append(st)
            acts.append(a)
            names.append(f"case{case}_{name}")
    stacked = {k: np.stack([getattr(s, k) for s in states])
               for k in tcore._FIELDS}
    state = tcore.EnvState.from_numpy(stacked, device="cpu")
    acts = torch.from_numpy(np.stack(acts))                  # (15, 60, 2)

    rec = {k: [] for k in ("ego", "reward", "terminated", "truncated",
                           "target_idx")}
    for i in range(acts.shape[1]):
        state, r, term, trunc, _ = tcore.step(tcfg, tassets, state, acts[:, i])
        rec["ego"].append(state.agent_states[:, 0])
        rec["reward"].append(r)
        rec["terminated"].append(term)
        rec["truncated"].append(trunc)
        rec["target_idx"].append(state.target_idx)
    rec = {k: torch.stack(v, dim=1).numpy() for k, v in rec.items()}

    golden = np.load(golden_path())
    assert len(golden.files) == 75
    for i, prefix in enumerate(names):
        for k, v in rec.items():
            g = golden[f"{prefix}_{k}"]
            if g.dtype == bool:
                np.testing.assert_array_equal(v[i], g, err_msg=f"{prefix}_{k}")
            else:
                np.testing.assert_allclose(v[i], g, **GOLDEN_TOL,
                                           err_msg=f"{prefix}_{k}")


# --------------------------------------------------------------------------
# (b) reset parity from JAX's own draws
# --------------------------------------------------------------------------


def _jax_draws(assets, key):
    """The random quantities core.reset draws from `key`, split as it
    splits them (env/core.py reset and _spawn_candidates)."""
    (k_case, k_start, k_speed, k_head, k_attr, k_bgfile, k_spawn, k_phase,
     _k_carry) = jax.random.split(key, 9)
    case = jax.random.randint(k_case, (), 0, assets.suite.case_town.shape[0])
    town = assets.suite.case_town[case]
    probs = assets.background.bg_valid[town].astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    bg_file = jax.random.choice(k_bgfile, assets.background.bg_valid.shape[1],
                                p=probs)
    ku = jax.random.split(k_attr, 3)
    n = jcore.SPAWN_GRID * jcore.SPAWN_GRID
    k_xy, k_psi, k_sp, k_len, k_wid, k_lr = jax.random.split(k_spawn, 6)
    return dict(
        case=case, frac=jax.random.uniform(k_start),
        speed_u=jax.random.uniform(k_speed), head_n=jax.random.normal(k_head),
        attr_u=jnp.stack([jax.random.uniform(k) for k in ku]),
        bg_file=bg_file, phase_u=jax.random.uniform(k_phase),
        spawn_jitter=jax.random.uniform(k_xy, (n, 2), minval=-jcore.SPAWN_JITTER,
                                        maxval=jcore.SPAWN_JITTER),
        spawn_psi_n=jax.random.normal(k_psi, (n,)),
        spawn_speed=jax.random.uniform(k_sp, (n,), minval=2.0, maxval=8.0),
        spawn_len=jax.random.uniform(k_len, (n,), minval=4.2, maxval=5.2),
        spawn_wid=jax.random.uniform(k_wid, (n,), minval=1.8, maxval=2.1),
        spawn_lr=jax.random.uniform(k_lr, (n,), minval=0.9, maxval=1.6),
    )


_KEYS = np.arange(8, dtype=np.uint32) + 100


def _jax_reset(jassets, ego_only):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(_KEYS))
    return jax.vmap(
        lambda k: jcore.reset(JEnvConfig(ego_only=ego_only), jassets, k))(keys)


@pytest.fixture(scope="module")
def traffic_state(jassets):
    """Un-jitted JAX traffic reset of 8 envs, shared by (b) and (c)."""
    return _jax_reset(jassets, ego_only=False)


@pytest.mark.parametrize("ego_only", [False, True])
def test_reset_parity(jassets, tassets, traffic_state, ego_only):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(_KEYS))
    want = _np_tree(traffic_state if not ego_only
                    else _jax_reset(jassets, ego_only=True))
    draws = jax.vmap(functools.partial(_jax_draws, jassets))(keys)
    draws = tcore.ResetDraws(**{k: torch.from_numpy(np.array(v))
                                for k, v in draws.items()})
    got = tcore.reset_from_draws(TEnvConfig(ego_only=ego_only), tassets,
                                 draws).to_numpy()
    for k in tcore._FIELDS:
        w = getattr(want, k)
        assert got[k].shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(got[k], w, atol=1e-4, rtol=1e-5,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    if not ego_only:
        assert (want.present.sum(-1) > 40).all(), "traffic was spawned"


def test_sampled_reset_draws_are_in_range(tassets):
    """The torch draws follow the JAX distributions' supports."""
    g = torch.Generator().manual_seed(0)
    cfg = TEnvConfig()
    d = tcore.sample_reset_draws(256, g, tassets, cfg)
    town = tassets.suite.case_town[d.case.long()].long()
    assert tassets.background.bg_valid[town, d.bg_file.long()].all()
    assert d.spawn_jitter.abs().max() <= tcore.SPAWN_JITTER
    assert d.spawn_speed.min() >= 2.0 and d.spawn_speed.max() <= 8.0
    st = tcore.reset_from_draws(cfg, tassets, d)
    assert st.present[:, 0].all() and (st.step_idx == 0).all()
    assert (st.target_idx == 1).all()


# --------------------------------------------------------------------------
# (c) traffic step parity
# --------------------------------------------------------------------------


def _compare(got, want, tol, what):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, **tol, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def test_traffic_step_parity(jassets, tassets, traffic_state):
    jcfg, tcfg = JEnvConfig(), TEnvConfig()
    actions = np.tile(np.array([[0.4, 0.05]], np.float32), (8, 1))
    want = jax.vmap(functools.partial(jcore.step, jcfg, jassets))(
        traffic_state, jnp.asarray(actions))
    state = tcore.EnvState.from_numpy(_np_tree(traffic_state), device="cpu")
    got = tcore.step(tcfg, tassets, state, torch.from_numpy(actions))
    for k in tcore._FIELDS:
        _compare(getattr(got[0], k), getattr(want[0], k), GOLDEN_TOL, k)
    for i, name in ((1, "reward"), (2, "terminated"), (3, "truncated")):
        _compare(got[i], want[i], GOLDEN_TOL, name)
    assert set(got[4]) == set(want[4])
    for k in want[4]:
        _compare(got[4][k], want[4][k], GOLDEN_TOL, k)


def test_traffic_rollout_parity(jassets, tassets, traffic_state):
    jcfg, tcfg = JEnvConfig(), TEnvConfig()
    jstep = jax.jit(jax.vmap(functools.partial(jcore.step, jcfg, jassets)))
    actions = np.tile(np.array([[0.4, 0.05]], np.float32), (8, 1))
    tstate = tcore.EnvState.from_numpy(_np_tree(traffic_state), device="cpu")
    jstate = traffic_state
    for i in range(10):
        jstate, _, jterm, jtrunc, _ = jstep(jstate, jnp.asarray(actions))
        tstate, _, tterm, ttrunc, _ = tcore.step(tcfg, tassets, tstate,
                                                 torch.from_numpy(actions))
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
        np.testing.assert_array_equal(tstate.present.numpy(),
                                      np.asarray(jstate.present))
        np.testing.assert_allclose(tstate.agent_states.numpy(),
                                   np.asarray(jstate.agent_states),
                                   atol=1e-3, rtol=0, err_msg=f"step {i}")


def test_state_round_trip_and_select(tassets):
    g = torch.Generator().manual_seed(3)
    a = tcore.reset(TEnvConfig(), tassets, 4, g)
    b = tcore.reset(TEnvConfig(), tassets, 4, g)
    again = tcore.EnvState.from_numpy(a.to_numpy(), device="cpu")
    for k in tcore._FIELDS:
        assert torch.equal(getattr(again, k), getattr(a, k)), k
    done = torch.tensor([True, False, True, False])
    mixed = a.select(done, b)
    assert torch.equal(mixed.agent_states[0], b.agent_states[0])
    assert torch.equal(mixed.agent_states[1], a.agent_states[1])
    taken = b.take(torch.tensor([3, 3, 0]))
    assert taken.town.shape == (3,)
    assert torch.equal(taken.agent_states[1], b.agent_states[3])


def test_config_copies_the_jax_fields():
    """The port's config dataclasses are field-for-field copies, with the
    same defaults (the renderer backend names differ by design)."""
    import dataclasses

    from torchdriveenv_tpu import config as jc
    from torchdriveenv_tpu_torch import config as tc

    for name in ("RendererConfig", "TorchDriveConfig", "EnvConfig"):
        jf = {f.name: f for f in dataclasses.fields(getattr(jc, name))}
        tf = {f.name: f for f in dataclasses.fields(getattr(tc, name))}
        assert list(jf) == list(tf), name
    jdef, tdef = jc.EnvConfig(), tc.EnvConfig()
    for f in dataclasses.fields(jdef):
        if f.name != "simulator":
            assert getattr(jdef, f.name) == getattr(tdef, f.name), f.name
    assert [m.value for m in jc.CollisionMetric] == \
        [m.value for m in tc.CollisionMetric]


# --------------------------------------------------------------------------
# (d) policy mode: the GRU NPCs and their hidden state
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def policy_reset(jassets):
    """Un-jitted JAX policy-mode reset of the 8 envs of (b)."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(_KEYS))
    return jax.vmap(lambda k: jcore.reset(JEnvConfig(npc_mode="policy"),
                                          jassets, k))(keys)


def test_policy_reset_carries_a_zero_hidden_state(jassets, tassets,
                                                  policy_reset):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(_KEYS))
    draws = jax.vmap(functools.partial(_jax_draws, jassets))(keys)
    draws = tcore.ResetDraws(**{k: torch.from_numpy(np.array(v))
                                for k, v in draws.items()})
    got = tcore.reset_from_draws(TEnvConfig(npc_mode="policy"), tassets,
                                 draws).to_numpy()
    want = np.asarray(policy_reset.npc_hidden)
    assert want.shape == (8, 96, 16) and got["npc_hidden"].shape == want.shape
    assert not got["npc_hidden"].any() and not want.any()
    route = tcore.reset_from_draws(TEnvConfig(), tassets, draws)
    assert route.npc_hidden is None and "npc_hidden" not in route.to_numpy()


def test_policy_rollout_parity(jassets, tassets, policy_reset):
    """10 policy-mode steps of 8 traffic envs, the JAX side un-jitted:
    every field, the hidden state, reward and info at the golden tolerance,
    flags exact. No agent's heading error comes within 1e-5 of the GRU
    features' fold at pi/2 in these steps (counted on the port's side)."""
    from test_torch_policy_net import _at_fold

    jcfg, tcfg = JEnvConfig(npc_mode="policy"), TEnvConfig(npc_mode="policy")
    jstep = jax.vmap(functools.partial(jcore.step, jcfg, jassets))
    actions = np.tile(np.array([[0.4, 0.05]], np.float32), (8, 1))
    jstate = policy_reset
    tstate = tcore.EnvState.from_numpy(_np_tree(policy_reset), device="cpu")
    assert tstate.npc_hidden is not None
    for i in range(10):
        assert not _at_fold(tassets, tstate.town.numpy(),
                            tstate.agent_states.numpy()).any(), f"step {i}"
        want = jstep(jstate, jnp.asarray(actions))
        with torch.no_grad():
            got = tcore.step(tcfg, tassets, tstate, torch.from_numpy(actions))
        for k in tcore._FIELDS + ("npc_hidden",):
            _compare(getattr(got[0], k), getattr(want[0], k), GOLDEN_TOL,
                     f"step {i} {k}")
        for j, name in ((1, "reward"), (2, "terminated"), (3, "truncated")):
            _compare(got[j], want[j], GOLDEN_TOL, f"step {i} {name}")
        for k in want[4]:
            _compare(got[4][k], want[4][k], GOLDEN_TOL, f"step {i} {k}")
        jstate, tstate = want[0], got[0]
    assert np.abs(np.asarray(jstate.npc_hidden)).max() > 0.1
    # the GRU, not the route follower, moved the NPCs
    route = tcore.step(TEnvConfig(), tassets, tstate.replace(npc_hidden=None),
                       torch.from_numpy(actions))[0]
    assert not torch.equal(route.agent_states, got[0].agent_states)


def test_state_round_trip_and_select_carry_the_hidden_state(tassets):
    g = torch.Generator().manual_seed(4)
    cfg = TEnvConfig(npc_mode="policy")
    a = tcore.reset(cfg, tassets, 4, g)
    b = tcore.reset(cfg, tassets, 4, g)
    a = a.replace(npc_hidden=torch.randn(a.npc_hidden.shape, generator=g))
    again = tcore.EnvState.from_numpy(a.to_numpy(), device="cpu")
    assert torch.equal(again.npc_hidden, a.npc_hidden)
    done = torch.tensor([True, False, True, False])
    mixed = a.select(done, b)
    assert not mixed.npc_hidden[done].any()
    assert torch.equal(mixed.npc_hidden[~done], a.npc_hidden[~done])
    taken = a.take(torch.tensor([3, 3, 0]))
    assert torch.equal(taken.npc_hidden[1], a.npc_hidden[3])
    with pytest.raises(ValueError, match="npc_hidden"):
        tcore.step(cfg, tassets, a.replace(npc_hidden=None),
                   torch.zeros(4, 2))
