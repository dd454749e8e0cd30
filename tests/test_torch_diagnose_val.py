"""The port's validation diagnostics (``tools/diagnose_val.py``) against the
JAX tool's ``make_probe``: each of the six probes on the 5 validation cases,
4 episodes each, over 30 steps from the same initial states. The episodes'
time limit is those 30 steps, so every episode ends (by an infraction, or
truncated at the last step) and every snapshot field is compared.

Both tools draw their resets from their own generators; each is handed the
same JAX reset batch through a stand-in for the ``core`` module in the
tool's own namespace (the JAX stand-in indexes a batch of states by its
"key", an episode index; ``step`` stays the real one). The loop steps
``core.step`` with no auto-reset in both. The ``sac`` probe runs the
shipped deliverable actor (f32 on both sides, carried across by
``models/convert.py``) on frame stacks of the rasterizer (the port's twin
on the CPU, the JAX package's XLA renderer).

Exact: ``cause``, ``step``, ``reached``, ``target``, ``near_slot``. Within
atol 1e-4 / rtol 1e-5: the float snapshot fields.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_sac import _jax_state
from tools import diagnose_val as jdv
from torchdriveenv_tpu.env import core as jcore
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu.rl import sac as jsac
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.models import convert, load_actor
from torchdriveenv_tpu_torch.rl.sac import SAC
from torchdriveenv_tpu_torch.tools import diagnose_val as tdv

torch.set_num_threads(2)
E, STEPS, N_CASES = 4, 30, 5
TOL = dict(atol=1e-4, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jassets():
    return jload("val")


@functools.lru_cache(maxsize=None)
def _resets():
    """JAX resets of E episodes for each case: a tree of (N_CASES, E, ...)
    arrays, drawn with the tool's own config."""
    jassets = _jassets()
    cfg = _jax_cfg()
    keys = jax.random.split(jax.random.PRNGKey(42), E)
    per_case = [jax.jit(jax.vmap(lambda k, c=c: jcore.reset(
        cfg, jassets, k, case=jnp.int32(c))))(keys) for c in range(N_CASES)]
    return jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                        *per_case)


def _jax_cfg():
    from torchdriveenv_tpu.config import EnvConfig
    return EnvConfig(ego_only=False, use_background_traffic=True,
                     terminated_at_infraction=True, frame_stack=3,
                     distance_cutoff=0.25, max_environment_steps=STEPS)


def _torch_cfg():
    return dataclasses.replace(tdv.probe_config(),
                               max_environment_steps=STEPS)


@functools.lru_cache(maxsize=None)
def _agents():
    """The shipped actor in a port SAC agent (f32) and the JAX agent and
    state that hold the same weights."""
    tagent = SAC(compute_dtype=torch.float32)
    tagent.init(seed=0, device="cpu")
    tagent.state.actor.load_state_dict(
        load_actor(device="cpu", compute_dtype=torch.float32).state_dict())
    jagent = jsac.SAC(jsac.SACConfig())
    jagent.actor = jpol.SquashedGaussianActor(compute_dtype=jnp.float32)
    jstate = _jax_state(convert.sac_state_from_torch(tagent.export_state()))
    return tagent, jagent, jstate


@functools.lru_cache(maxsize=None)
def _jax_snaps(kind):
    """{field: (N_CASES, E)} from the JAX tool's probe, its resets handed
    over by a stand-in ``core``."""
    states = jax.tree.map(jnp.asarray, _resets())
    stand_in = types.SimpleNamespace(
        reset=lambda cfg, assets, k, case=None: jax.tree.map(
            lambda x: x[case, k], states),
        step=jcore.step, ACTION_LOW=jcore.ACTION_LOW,
        ACTION_HIGH=jcore.ACTION_HIGH)
    _, jagent, jstate = _agents()
    plain = jdv.core
    jdv.core = stand_in
    try:
        probe = jdv.make_probe(_jax_cfg(), _jassets(), kind, jagent, jstate,
                               max_steps=STEPS)
        snaps = [jax.tree.map(np.asarray, probe(jnp.arange(E),
                                                jnp.int32(c)))
                 for c in range(N_CASES)]
    finally:
        jdv.core = plain
    return {k: np.stack([s[k] for s in snaps]) for k in snaps[0]}


def _torch_snaps(kind, monkeypatch):
    handed = [tcore.EnvState.from_numpy(
        jax.tree.map(lambda x, c=c: x[c], _resets()), device="cpu")
        for c in range(N_CASES)]
    seen = []

    def reset(cfg, assets, n, generator, case=None, mesh=None):
        seen.append(case.tolist())
        return handed[case[0].item()]

    monkeypatch.setattr(tdv, "core", types.SimpleNamespace(
        reset=reset, step=tcore.step, ACTION_LOW=tcore.ACTION_LOW,
        ACTION_HIGH=tcore.ACTION_HIGH))
    probe = tdv.make_probe(_torch_cfg(), tload("val", device="cpu"), kind,
                           _agents()[0],
                           max_steps=STEPS)
    g = torch.Generator().manual_seed(0)
    snaps = [probe(g, E, c) for c in range(N_CASES)]
    assert seen == [[c] * E for c in range(N_CASES)]
    return {k: np.stack([s[k].numpy() for s in snaps]) for k in snaps[0]}


@pytest.mark.parametrize("kind", tdv.PROBES)
def test_probe_matches_jax(kind, monkeypatch):
    want = _jax_snaps(kind)
    got = _torch_snaps(kind, monkeypatch)
    assert sorted(got) == sorted(want) == sorted(tdv.INT_FIELDS
                                                 + tdv.FLOAT_FIELDS)
    for k in tdv.INT_FIELDS:
        assert got[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{kind} {k}")
    for k in tdv.FLOAT_FIELDS:
        assert got[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], **TOL,
                                   err_msg=f"{kind} {k}")
    assert (want["cause"] < 4).all(), "an episode outlived its time limit"


def test_the_probes_end_episodes_in_several_ways():
    """The comparison above reads infractions as well as truncations
    (counted over all probes, cases and episodes)."""
    every = np.concatenate([_jax_snaps(k)["cause"].ravel()
                            for k in tdv.PROBES])
    assert (every == 3).sum() > 0, "no episode truncated"
    assert ((every == 0) | (every == 1) | (every == 2)).sum() >= 6
