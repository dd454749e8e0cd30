"""The port's NPC-policy tools: ``npc/policy_net.py:save_npc_policy`` and
``tools/distill_npc.py``. A saved policy loads back bit-equal; a short
distillation on the CPU writes a file whose weights, carried into the JAX
package's ``NpcGRU`` by ``models/convert.py``, give the port's actions and
next hidden state within 1e-5 on a JAX reset batch (hidden states drawn at
random, so the recurrent kernels count). Agents within 1e-5 of the
features' heading fold are counted and left out (none in this scene)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_policy_net import TOL, _args, _at_fold
from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env import core as jcore
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.npc import policy_net as jpn
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.npc import policy_net as tpn
from torchdriveenv_tpu_torch.tools import distill_npc

torch.set_num_threads(2)


def test_save_round_trips_bit_equal(tmp_path):
    policy = tpn.init_policy(torch.Generator().manual_seed(3), "cpu")
    path = tpn.save_npc_policy(policy, str(tmp_path / "gru"))
    assert path == str(tmp_path / "gru")            # no suffix added
    back = tpn.load_npc_policy(path, device="cpu")
    want, got = policy.state_dict(), back.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    with np.load(path) as z:
        assert sorted(z.files) == sorted(want)


def test_save_defaults_to_the_shipped_asset(monkeypatch, tmp_path):
    target = str(tmp_path / "npc_gru_v1.npz")
    monkeypatch.setattr(tpn, "NPC_POLICY", target)
    assert tpn.save_npc_policy(tpn.NpcGRU()) == target
    assert tpn.load_npc_policy(device="cpu") is not None


@pytest.fixture(scope="module")
def distilled(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("distill") / "gru.npz")
    res = distill_npc.main(["--steps", "3", "--batch", "8", "--device",
                            "cpu", "--out", out])
    assert res["path"] == out and res["loss"] > 0
    loaded = tpn.load_npc_policy(out, device="cpu").state_dict()
    for k, v in res["policy"].state_dict().items():
        assert torch.equal(v, loaded[k]), k
    return out


def test_distill_main_writes_a_trained_policy(distilled):
    policy = tpn.load_npc_policy(distilled, device="cpu")
    fresh = tpn.init_policy(torch.Generator().manual_seed(0), "cpu")
    moved = [k for k, v in policy.state_dict().items()
             if not torch.equal(v, fresh.state_dict()[k])]
    assert moved, "three Adam steps moved no weight"


def test_distill_refuses_no_gpu_without_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        distill_npc.main(["--steps", "1"])


def test_distilled_weights_drive_the_jax_gru_alike(distilled):
    jassets, tassets = jload("val"), tload("val", device="cpu")
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(4, dtype=jnp.uint32) + 7)
    st = jax.tree.map(np.array, jax.jit(jax.vmap(functools.partial(
        jcore.reset, JEnvConfig(npc_mode="policy"), jassets)))(keys))
    hidden = np.random.default_rng(1).normal(
        size=st.npc_hidden.shape).astype(np.float32)
    policy = tpn.load_npc_policy(distilled, device="cpu")
    params = jax.tree.map(jnp.asarray,
                          convert.npc_params_from_torch(policy.state_dict()))
    want_a, want_h = jax.vmap(functools.partial(
        jpn.npc_policy_actions, params, jassets.maps))(*_args(st), hidden)
    with torch.no_grad():
        got_a, got_h = tpn.npc_policy_actions(
            policy, tassets.maps, *map(torch.from_numpy, _args(st)),
            torch.from_numpy(hidden))
    fold = _at_fold(tassets, st.town, st.agent_states)
    assert fold.sum() == 0, f"{fold.sum()} agents at the fold"
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    assert st.present.sum() > 40 and np.abs(np.asarray(want_a)).max() > 0.1


def test_a_batched_env_drives_its_npcs_with_the_given_policy(distilled):
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env.batched import BatchedEnv
    tassets = tload("val", device="cpu")
    policy = tpn.load_npc_policy(distilled, device="cpu")
    cfg = EnvConfig(npc_mode="policy")
    mine = BatchedEnv(cfg, tassets, 4, device="cpu", render=False,
                      npc_params=policy)
    shipped = BatchedEnv(cfg, tassets, 4, device="cpu", render=False)
    state, _ = mine.reset()
    act = torch.tensor([[0.3, 0.0]]).repeat(4, 1)
    got = mine.step(state, act).state
    other = shipped.step(state, act).state
    with torch.no_grad():
        want = tcore.step(cfg, tassets, state, act, npc_params=policy)[0]
    assert policy.GRUCell_0.ir.weight.requires_grad
    assert not got.npc_hidden.requires_grad     # no graph across steps
    assert torch.equal(got.npc_hidden, want.npc_hidden)
    assert torch.equal(got.agent_states, want.agent_states)
    assert not torch.equal(got.npc_hidden, other.npc_hidden)
