"""The JAX reference file the port is held to on any device, its recorder,
and the port's check against it on the CPU.

``torchdriveenv_tpu_torch/assets/jax_reference_v1.npz`` holds the JAX
package's outputs on small inputs, so that a machine without JAX (the GPU
machine) can hold the port to them (``utils/reference.py``,
``chip_smoke.py`` ``[parity]``):

  golden/   the draws and the (jitted) reset states of the 5 validation
            cases of tools/golden_trajectories.py, and its 3 action scripts
            (the expected trajectories are the JAX package's golden file);
  traffic/  the draws of the 8 keys 100-107 and the un-jitted JAX reset
            states in route, policy and ego-only mode; 10 steps of seeded
            actions in route and policy mode (the shipped GRU), with every
            state field, reward, flags and info after each step;
  pool/     one pooled auto-reset (8 envs, 6 done, a pool of 4): the states
            before, the pool's draws and states, the states after and the
            pool entry each env took.

Re-record after any change to the JAX package's step semantics or its
golden file, on the CPU:

    JAX_PLATFORMS=cpu python tests/test_torch_card_reference.py record
"""

import ast
import functools
import glob
import os
import sys

import jax

if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from test_torch_core import _KEYS, _jax_draws  # noqa: E402
from tools.golden_trajectories import SEED, action_sequences  # noqa: E402
from torchdriveenv_tpu.config import EnvConfig as JEnvConfig  # noqa: E402
from torchdriveenv_tpu.env import batched as jbatched  # noqa: E402
from torchdriveenv_tpu.env import core as jcore  # noqa: E402
from torchdriveenv_tpu.maps.arrays import load_assets as jload  # noqa: E402
from torchdriveenv_tpu_torch.config import EnvConfig as TEnvConfig  # noqa: E402
from torchdriveenv_tpu_torch.env import core as tcore  # noqa: E402
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload  # noqa: E402
from torchdriveenv_tpu_torch.rl import train as train_mod  # noqa: E402
from torchdriveenv_tpu_torch.utils import precision, reference  # noqa: E402

torch.set_num_threads(2)
POOL_DONE = np.array([1, 0, 1, 1, 0, 1, 1, 1], bool)   # 6 done > pool of 4
POOL = 4
PORT = os.path.dirname(os.path.dirname(os.path.abspath(precision.__file__)))


def _fields(state):
    names = tcore._FIELDS + (("npc_hidden",) if state.npc_hidden is not None
                             else ())
    return {k: np.asarray(getattr(state, k)) for k in names}


def _put(out, prefix, tree):
    for k, v in tree.items():
        out[f"{prefix}/{k}"] = np.asarray(v)


def _draws(jassets, keys, case=None):
    d = jax.vmap(functools.partial(_jax_draws, jassets))(keys)
    d = {k: np.asarray(v) for k, v in d.items()}
    if case is not None:
        d["case"] = np.asarray(case, np.int32)
    return d


def _record_golden(jassets, out):
    cfg = JEnvConfig(ego_only=True, seed=SEED)
    reset = jax.jit(functools.partial(jcore.reset, cfg, jassets))
    cases = np.arange(5, dtype=np.int32)
    keys = jnp.stack([jax.random.PRNGKey(SEED + int(c)) for c in cases])
    _put(out, "golden/draws", _draws(jassets, keys, cases))
    states = [reset(keys[c], jnp.asarray(c)) for c in cases]
    _put(out, "golden/reset", {k: np.stack([_fields(s)[k] for s in states])
                               for k in tcore._FIELDS})
    _put(out, "golden/actions", action_sequences())


def _record_traffic(jassets, out):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(_KEYS))
    _put(out, "traffic/draws", _draws(jassets, keys))
    n = len(_KEYS)
    actions = np.random.default_rng(reference.TRAFFIC_ACTION_SEED).uniform(
        (-1.0, -0.3), (1.0, 0.3), (reference.TRAFFIC_STEPS, n, 2)
    ).astype(np.float32)
    out["traffic/actions"] = actions
    for mode, kw in reference.TRAFFIC_MODES.items():
        cfg = JEnvConfig(**kw)
        state = jax.vmap(lambda k, cfg=cfg: jcore.reset(cfg, jassets, k))(keys)
        _put(out, f"traffic/reset/{mode}", _fields(state))
        if mode not in reference.ROLLOUT_MODES:
            continue
        step = jax.vmap(functools.partial(jcore.step, cfg, jassets))
        rec = {}
        for t in range(reference.TRAFFIC_STEPS):
            state, r, term, trunc, info = step(state, jnp.asarray(actions[t]))
            row = {f"state/{k}": v for k, v in _fields(state).items()}
            row.update(reward=r, terminated=term, truncated=trunc,
                       **{f"info/{k}": v for k, v in info.items()})
            for k, v in row.items():
                rec.setdefault(k, []).append(np.asarray(v))
        _put(out, f"traffic/{mode}", {k: np.stack(v) for k, v in rec.items()})


def _record_pool(jassets, out):
    cfg = JEnvConfig(reset_pool=POOL)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(len(POOL_DONE),
                                                   dtype=jnp.uint32))
    nxt = jax.vmap(lambda k: jcore.reset(cfg, jassets, k))(keys)
    res, pool, idx = jbatched._autoreset(cfg, jassets, nxt,
                                         jnp.asarray(POOL_DONE))
    # the pool's keys, split from the envs' keys as _autoreset splits them
    k_reset = jax.vmap(jax.random.split)(nxt.rng)[:POOL, 0]
    _put(out, "pool/next", _fields(nxt))
    _put(out, "pool/draws", _draws(jassets, k_reset))
    _put(out, "pool/fresh", _fields(pool))
    _put(out, "pool/out", _fields(res))
    out["pool/done"] = POOL_DONE
    out["pool/idx"] = np.asarray(idx)


def record() -> dict:
    """Every array of the reference file, computed by the JAX package now."""
    jassets = jload("val")
    out = {}
    _record_golden(jassets, out)
    _record_traffic(jassets, out)
    _record_pool(jassets, out)
    return out


# --------------------------------------------------------------------------
# tests
# --------------------------------------------------------------------------


def test_reference_file_is_what_jax_computes_now():
    want = record()
    got = np.load(reference.REFERENCE_PATH)
    assert sorted(got.files) == sorted(want)
    assert os.path.getsize(reference.REFERENCE_PATH) <= 4 << 20
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def cpu_checks():
    return reference.run_reference_checks(tload("val", device="cpu"), "cpu")


def test_port_on_the_cpu_passes_every_reference_check(cpu_checks):
    for name, c in cpu_checks.items():
        assert c["ok"], (name, c)
    assert cpu_checks["golden"]["flipped_envs"] == 0
    assert cpu_checks["golden"]["envs"] == 15
    for mode in reference.ROLLOUT_MODES:
        assert cpu_checks[f"traffic_{mode}"]["flipped_envs"] <= 1
    assert cpu_checks["pool"]["idx_equal"]


def test_reference_checks_see_a_fault(monkeypatch):
    """A port whose reward is off by more than the tolerance fails the
    checks that step (the checks compare; they do not only run)."""
    plain = tcore.step

    def off(*a, **k):
        nxt, r, term, trunc, info = plain(*a, **k)
        return nxt, r + 1e-3, term, trunc, info

    monkeypatch.setattr(tcore, "step", off)
    res = reference.run_reference_checks(tload("val", device="cpu"), "cpu")
    assert not res["golden"]["ok"] and not res["traffic_route"]["ok"]
    assert res["reset_route"]["ok"] and res["pool"]["ok"]


def test_flip_tracker_counts_flips_and_stops_comparing_their_envs():
    b = 4
    want = {"flag": torch.zeros(b, dtype=torch.int32),
            "x": torch.zeros(b, 3), "info/offroad": torch.zeros(b)}
    got = {k: v.clone() for k, v in want.items()}
    got["flag"][2] = 1                  # env 2 flips ...
    got["x"][2] = 5.0                   # ... so its floats are not compared
    got["info/offroad"][1] = 0.5        # env 1's infraction flag flips
    got["x"][3] = 5e-5                  # within atol 1e-4
    tr = reference.FlipTracker(envs=b, bound=2)
    tr.update(got, want)
    res = tr.result()
    assert res["ok"] and res["flipped_envs"] == 2
    assert res["flips_by"] == {"flag": 1, "info/offroad": 1}
    assert res["max_err"] == pytest.approx(5e-5)
    tight = reference.FlipTracker(envs=b, bound=1)
    tight.update(got, want)
    assert not tight.result()["ok"]
    got["x"][0] = 1e-3                  # a float fault in an env that held
    tr.update(got, want)
    assert not tr.result()["ok"] and "env 0" in tr.result()["float_fail"]


@pytest.mark.parametrize("mode", reference.ROLLOUT_MODES)
def test_npc_decisions_part_where_an_npc_moves(mode):
    """Moving one NPC across the map changes its decisions, and only its
    env flips."""
    cfg = TEnvConfig(**reference.TRAFFIC_MODES[mode])
    assets = tload("val", device="cpu")
    state = tcore.reset(cfg, assets, 4, torch.Generator().manual_seed(1))
    moved = state.agent_states.clone()
    agent = int(torch.nonzero(state.present[1, 1:])[0]) + 1
    moved[1, agent, :2] += 37.0
    other = state.replace(agent_states=moved)
    want = reference.npc_decisions(cfg, assets.maps, state)
    got = reference.npc_decisions(cfg, assets.maps, other)
    assert want["decision/cell"].shape == (4, state.present.shape[1], 2)
    assert (want["decision/cell"][~state.present] == -1).all()
    tr = reference.FlipTracker(envs=4, bound=1)
    tr.update(got, want)
    assert tr.result()["flipped_envs"] == 1 and bool(tr.flipped[1])
    assert "decision/cell" in tr.result()["flips_by"]


def test_set_f32_precision_sets_both_flags(monkeypatch):
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    precision.set_f32_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_train_sets_the_f32_precision(tmp_path, monkeypatch):
    """A short CPU run of the CLI's ``train`` calls the precision function
    once, with its default, and leaves both TF32 flags off."""
    from test_torch_train_cli import _cfg
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    calls = []

    def recorded(*a, **k):
        calls.append((a, k))
        precision.set_f32_precision(*a, **k)

    monkeypatch.setattr(train_mod, "set_f32_precision", recorded)
    train_mod.train(_cfg("a2c", tmp_path, 16))
    assert calls == [((), {})]
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_every_entry_point_sets_the_f32_precision():
    """Every tool's and example's ``main`` calls the precision function,
    and no other module of the port sets a TF32 flag."""
    mains = 0
    for path in (glob.glob(os.path.join(PORT, "tools", "*.py"))
                 + glob.glob(os.path.join(PORT, "examples", "*.py"))):
        with open(path) as f:
            tree = ast.parse(f.read())
        for fn in tree.body:
            if isinstance(fn, ast.FunctionDef) and fn.name == "main":
                called = {n.func.id for n in ast.walk(fn)
                          if isinstance(n, ast.Call)
                          and isinstance(n.func, ast.Name)}
                assert "set_f32_precision" in called, path
                mains += 1
    assert mains == 8
    setters = []
    for path in glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True):
        with open(path) as f:
            if "allow_tf32" in f.read():
                setters.append(os.path.relpath(path, PORT))
    assert setters == [os.path.join("utils", "precision.py")]


def main():
    if sys.argv[1:2] != ["record"]:
        sys.exit("usage: python tests/test_torch_card_reference.py record")
    out = record()
    np.savez_compressed(reference.REFERENCE_PATH, **out)
    print(f"recorded {len(out)} arrays -> {reference.REFERENCE_PATH} "
          f"({os.path.getsize(reference.REFERENCE_PATH)} bytes)")


if __name__ == "__main__":
    main()
