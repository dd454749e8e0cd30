"""Data parallelism over ``torch.distributed`` (``parallel/mesh.py``) on the
CPU: two ranks under gloo must take the steps of one process.

Every case runs twice: sharded over two ranks, each a subprocess of this
module (``python tests/test_torch_mesh.py <case> <rank> <world> <store>``,
the ranks meeting through ``init_method=file://<store>``), and in the test
process with no mesh. The ranks gather what they hold with the package's own
``fetch_to_host``, and rank 0's gathered result is held to the one-process
result:

  - rollouts of 8 validation envs (4 steps, episodes of 3 so that the exact
    auto-reset runs): ego-only (the JAX package's own case,
    ``tests/test_multihost.py:54``) and full traffic, and a pooled-reset
    step with most envs done and the done envs unevenly split between the
    ranks, so the pool is consumed in global rank order. ``terminated`` /
    ``truncated`` / ints exact, floats at the golden tolerance (atol 1e-4,
    rtol 1e-5), frames equal but for at most a 1e-3 share of pixels (the JAX
    test's limit);
  - one train step each of SAC (with BC and three scripted demo envs), TD3,
    PPO and A2C: the parameters and Adam moments are bit-equal on both ranks
    and equal to the one-process step at the Adam-parity tolerances of
    ``tests/test_torch_sac.py`` (relative to each tensor's scale); the
    generator state is equal, so every draw was made at global width;
  - a two-rank ``rl.train.train`` writes ``model_*`` and ``full_latest`` from
    rank 0 only, and ``full_latest`` loaded in one process equals the
    one-process run's carry; so does a two-rank run resumed from it;
  - the row helpers on a mesh with no process group;
  - ``make_mesh`` refuses a ``num_envs`` the world does not divide.

Learners run in f32 (the CLI's bf16 torso is swapped for f32 in its case):
a batch split over two ranks reduces in another order, and bf16 would turn
that rounding into visible differences. Every subprocess wait and the
process group's set-up have timeouts, so a hang fails one test.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torchdriveenv_tpu_torch.config import (  # noqa: E402
    construct_env_config,
    construct_rl_training_config,
)
from torchdriveenv_tpu_torch.env.batched import BatchedEnv  # noqa: E402
from torchdriveenv_tpu_torch.maps.arrays import load_assets  # noqa: E402
from torchdriveenv_tpu_torch.parallel import mesh as pm  # noqa: E402
from torchdriveenv_tpu_torch.parallel.train_step import (  # noqa: E402
    make_offpolicy_train_fns,
    make_onpolicy_train_fns,
)

N = 8                   # global envs: 4 per rank
WORLD = 2
WORKER_TIMEOUT_S = 150
STATE_ATOL, STATE_RTOL = 1e-4, 1e-5
PIXEL_SHARE = 1e-3
ATOL, SCALE_RTOL = 2e-5, 1e-5      # tests/test_torch_sac.py
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


_ASSETS = {}


def _assets():
    if "val" not in _ASSETS:
        _ASSETS["val"] = load_assets("val", device="cpu")
    return _ASSETS["val"]


def _env_cfg(obs_res=64, **kw):
    return construct_env_config(dict(
        kw, simulator=dict(renderer=dict(obs_res=obs_res))))


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


# --------------------------------------------------------------------------
# the cases: each takes a mesh (None = one process) and returns what it
# compares, env rows gathered to the global batch on the host
# --------------------------------------------------------------------------


def _rollout(mesh, cfg, steps, step_idx=None):
    env = BatchedEnv(cfg, _assets(), N, device="cpu", seed=3, mesh=mesh)
    state, obs = env.reset()
    if step_idx is not None:
        state = state.replace(step_idx=pm.env_rows(step_idx, mesh))
    act = torch.tensor([[0.4, 0.05]]).repeat(state.town.shape[0], 1)
    rows = [dict(obs=obs, **_fields(state))]
    for _ in range(steps):
        out = env.step(state, act)
        state = out.state
        rows.append(dict(obs=out.obs, reward=out.reward,
                         terminated=out.terminated, truncated=out.truncated,
                         **_fields(state)))
    return dict(rows=pm.fetch_to_host(rows, mesh),
                generator=env.generator.get_state())


@case
def rollout_ego_only(mesh):
    return _rollout(mesh, _env_cfg(ego_only=True, reset_pool=0,
                                   max_environment_steps=3), steps=4)


@case
def rollout_traffic(mesh):
    return _rollout(mesh, _env_cfg(ego_only=False, reset_pool=0,
                                   max_environment_steps=3), steps=4)


@case
def rollout_pooled(mesh):
    # a pool of 3 for 8 envs; episodes of 2 steps. Envs 0, 2, 3 and 6 start
    # one step in, so the first step ends 3 episodes on rank 0 and 1 on
    # rank 1, whose done env must take pool entry (3 + 0) % 3 = 0; the
    # second step ends the other four
    return _rollout(mesh, _env_cfg(reset_pool=3, max_environment_steps=2),
                    steps=2, step_idx=torch.tensor([1, 0, 1, 1, 0, 0, 1, 0],
                                                   dtype=torch.int32))


def _train_steps(mesh, agent, offpolicy, n_steps=1, **kw):
    assets = _assets()
    cfg = _env_cfg(obs_res=20, max_environment_steps=3)
    if offpolicy:
        init_fn, step_fn = make_offpolicy_train_fns(
            cfg, agent, N, buffer_capacity=16, steps_per_iter=2,
            updates_per_iter=2, device="cpu", mesh=mesh, **kw)
    else:
        init_fn, step_fn = make_onpolicy_train_fns(cfg, agent, N,
                                                   device="cpu", mesh=mesh)
    carry = init_fn(assets, seed=0)
    metrics = []
    for _ in range(n_steps):
        carry, m = step_fn(assets, carry)
        metrics.append({k: float(v) for k, v in m.items()})
    envs = dict(env_state=_fields(carry.rollout.env_state),
                obs_stack=carry.rollout.obs_stack)
    if offpolicy:
        envs["buffer"] = _fields(carry.buffer)
    return dict(agent=agent.export_state(), metrics=metrics,
                envs=pm.fetch_to_host(envs, mesh),
                generator=carry.generator.get_state(),
                env_steps=carry.env_steps)


@case
def sac_step(mesh):
    from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    agent = SAC(SACConfig(batch_size=16, learning_starts=0, bc_coef=0.5),
                compute_dtype=torch.float32)
    demo_fn = make_scripted_driver(_env_cfg(obs_res=20), _assets())
    # the first 3 envs stay scripted: all on rank 0
    return _train_steps(mesh, agent, True, demo_fn=demo_fn, demo_envs=3)


@case
def td3_step(mesh):
    from torchdriveenv_tpu_torch.rl.td3 import TD3, TD3Config
    agent = TD3(TD3Config(batch_size=16, learning_starts=0),
                compute_dtype=torch.float32)
    return _train_steps(mesh, agent, True)


@case
def ppo_step(mesh):
    from torchdriveenv_tpu_torch.rl.ppo import PPO, PPOConfig
    agent = PPO(PPOConfig(n_steps=4, batch_size=8, n_epochs=2),
                compute_dtype=torch.float32)
    return _train_steps(mesh, agent, False)


@case
def a2c_step(mesh):
    from torchdriveenv_tpu_torch.rl.a2c import A2C, A2CConfig
    agent = A2C(A2CConfig(n_steps=4), compute_dtype=torch.float32)
    return _train_steps(mesh, agent, False)


def _cli_cfg(out_dir, total, ckpt):
    return construct_rl_training_config(dict(
        algorithm="sac", parallel_env_num=N, total_timesteps=total,
        algo_kwargs=dict(batch_size=16, learning_starts=16,
                         buffer_size=N * 64),
        log_dir=os.path.join(out_dir, "runs"),
        checkpoint_dir=os.path.join(out_dir, ckpt),
        offpolicy_steps_per_iter=2, offpolicy_updates_per_iter=2,
        env=dict(ego_only=True, max_environment_steps=5, device="cpu", seed=3,
                 simulator=dict(renderer=dict(obs_res=20))),
        eval_val_callback=dict(n_steps=10 ** 6, eval_n_episodes=2,
                               record=False),
        eval_train_callback=dict(n_steps=10 ** 6, eval_n_episodes=2),
        wandb_callback=dict(model_save_freq=10 ** 6)))


def run_cli(out_dir):
    """``rl.train.train`` with the learner in f32 for 3 train steps (the
    first warms up) into ``<out_dir>/ckpt``, then one more resumed from its
    ``full_latest`` into ``<out_dir>/resumed``; records what this process
    saved."""
    from torchdriveenv_tpu_torch.rl import train as train_mod
    plain_build, plain_save = train_mod.build_agent, train_mod._save
    tensorboard = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None   # a 10 s import here
    saved = []

    def build_f32(*a, **k):
        agent, on_policy = plain_build(*a, **k)
        agent.compute_dtype = torch.float32
        return agent, on_policy

    def save(ckpt_dir, name, tree):
        saved.append(name)
        return plain_save(ckpt_dir, name, tree)

    train_mod.build_agent, train_mod._save = build_f32, save
    try:
        train_mod.train(_cli_cfg(out_dir, 48, "ckpt"))
        train_mod.train(_cli_cfg(out_dir, 64, "resumed"), resume_from=(
            os.path.join(out_dir, "ckpt", "full_latest")))
    finally:
        train_mod.build_agent, train_mod._save = plain_build, plain_save
        if tensorboard is None:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = tensorboard
    return dict(saved=saved)


# --------------------------------------------------------------------------
# the worker side
# --------------------------------------------------------------------------


def worker(name, rank, world, store):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0")
    torch.set_num_threads(1)
    assert pm.maybe_init_distributed(backend="gloo",
                                     init_method=f"file://{store}",
                                     timeout_s=60)
    assert pm.maybe_init_distributed()      # re-entry is a no-op
    try:
        if name == "refuses_indivisible":
            try:
                pm.make_mesh(N - 1)
                out = dict(refused=False)
            except ValueError as e:
                out = dict(refused=True, message=str(e))
        elif name == "cli":
            out = run_cli(os.path.dirname(store))
        else:
            mesh = pm.make_mesh(N)
            assert (mesh.lo, mesh.hi) == (rank * N // world,
                                          (rank + 1) * N // world)
            out = CASES[name](mesh)
        torch.save(out, f"{store}.rank{rank}")
    finally:
        torch.distributed.destroy_process_group()


def spawn(name, tmp_path, world=WORLD, attempts=2):
    """Run case ``name`` on ``world`` ranks; -> each rank's result. A run
    whose ranks never met (gloo's TCP mesh set-up failed, before any code
    under test ran) is started once more with a fresh store."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])))
    for attempt in range(attempts):
        store = str(tmp_path / f"store{attempt}")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), name, str(r),
             str(world), store], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        failed = [(r, p.returncode, out)
                  for r, (p, out) in enumerate(zip(procs, outs))
                  if p.returncode]
        if not failed:
            return [torch.load(f"{store}.rank{r}", weights_only=False)
                    for r in range(world)]
        if not all("connectFullMesh failed" in out for _, _, out in failed):
            break
    raise AssertionError("\n".join(f"rank {r} exited {rc}:\n{out[-3000:]}"
                                    for r, rc, out in failed))


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    sys.exit(0)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

import pytest  # noqa: E402

torch.set_num_threads(2)


def assert_adam_close(got, want, name, atol=ATOL):
    """tests/test_torch_sac.py's tolerance: atol plus 1e-5 of the tensor's
    largest magnitude, at most 4 elements (or 1e-5 of them) over it, none
    by more than 100 times."""
    assert got.shape == want.shape and got.dtype == want.dtype, name
    diff = (got.double() - want.double()).abs()
    tol = atol + SCALE_RTOL * float(want.abs().max())
    n_over = int((diff > tol).sum())
    assert n_over <= max(4, got.numel() * 1e-5), (
        f"{name}: {n_over} of {got.numel()} elements over {tol:.3g}, "
        f"max {float(diff.max()):.3g}")
    assert float(diff.max()) <= 100 * tol, (
        f"{name}: max difference {float(diff.max()):.3g} over 100 x {tol:.3g}")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix.rstrip("."), tree


def assert_env_close(got, want, where):
    """Env-indexed trees: ints and bools exact, floats at the golden
    tolerance, uint8 frames equal but for a 1e-3 share of pixels."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want), where
    for k, w in want.items():
        g = got[k]
        if not isinstance(w, torch.Tensor):
            assert g == w, f"{where}: {k}"
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, f"{where}: {k}"
        if w.dtype == torch.uint8:
            share = float((g != w).float().mean())
            assert share <= PIXEL_SHARE, f"{where}: {k}: {share:.2e} differ"
        elif w.is_floating_point():
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=STATE_ATOL,
                                       rtol=STATE_RTOL, err_msg=f"{where}: {k}")
        else:
            assert torch.equal(g, w), f"{where}: {k}"


def assert_agents(ranks, one, where):
    """Bit-equal on every rank, and equal to one process at the Adam-parity
    tolerance; integer leaves (step counts) exact."""
    first = dict(_leaves(ranks[0]))
    for other in ranks[1:]:
        for k, v in _leaves(other):
            if isinstance(v, torch.Tensor):
                assert torch.equal(v, first[k]), f"{where}: rank differs: {k}"
            else:
                assert v == first[k], f"{where}: {k}"
    for k, w in _leaves(one):
        g = first[k]
        if isinstance(w, torch.Tensor) and w.is_floating_point():
            assert_adam_close(g, w, f"{where}: {k}")
        elif isinstance(w, torch.Tensor):
            assert torch.equal(g, w), f"{where}: {k}"
        else:
            assert g == w, f"{where}: {k}"


@pytest.mark.parametrize("name", ["rollout_ego_only", "rollout_traffic",
                                  "rollout_pooled"])
def test_sharded_rollout_equals_one_process(tmp_path, name):
    ranks = spawn(name, tmp_path)
    one = CASES[name](None)
    assert torch.equal(ranks[0]["generator"], ranks[1]["generator"])
    assert torch.equal(ranks[0]["generator"], one["generator"])
    for r in ranks:
        for t, (g, w) in enumerate(zip(r["rows"], one["rows"])):
            assert_env_close(g, w, f"{name} step {t}")
    rows = one["rows"]
    done = torch.stack([r["terminated"] | r["truncated"] for r in rows[1:]])
    assert done.any(), "no episode ended: the auto-reset went untested"
    if name == "rollout_pooled":
        # three envs of rank 0 and one of rank 1 ended on the first step
        assert torch.equal(done[0].nonzero()[:, 0], torch.tensor([0, 2, 3, 6]))
        assert done[1].sum() >= 4


@pytest.mark.parametrize("name", ["sac_step", "td3_step", "ppo_step",
                                  "a2c_step"])
def test_sharded_train_step_equals_one_process(tmp_path, name):
    ranks = spawn(name, tmp_path)
    one = CASES[name](None)
    assert_agents([r["agent"] for r in ranks], one["agent"], name)
    for r in ranks:
        assert torch.equal(r["generator"], one["generator"]), name
        assert r["env_steps"] == one["env_steps"]
        assert_env_close(r["envs"], one["envs"], name)
        for g, w in zip(r["metrics"], one["metrics"]):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name}: {k}")
    # the learner moved and its metrics are not the warm-up zeros
    assert any(v != 0 for k, v in one["metrics"][-1].items()
               if k != "mean_step_reward")


def test_two_rank_training_cli_checkpoints_once(tmp_path):
    """Two ranks write ``model_*`` and ``full_latest`` from rank 0 alone,
    equal to the one-process run's; resumed from their ``full_latest``
    (each rank keeping its rows) they take the one-process step."""
    (tmp_path / "ranks").mkdir()
    ranks = spawn("cli", tmp_path / "ranks")
    assert ranks[1]["saved"] == [], "rank 1 wrote a checkpoint"
    assert ranks[0]["saved"] == ["model_48", "full_latest", "model_64",
                                 "full_latest"]
    one_dir = tmp_path / "one"
    run_cli(str(one_dir))
    for ckpt, steps in (("ckpt", 48), ("resumed", 64)):
        got = torch.load(tmp_path / "ranks" / ckpt / "full_latest",
                         weights_only=True)
        want = torch.load(one_dir / ckpt / "full_latest", weights_only=True)
        assert sorted(got) == sorted(want)
        assert got["env_steps"] == want["env_steps"] == steps
        assert torch.equal(got["generator"], want["generator"])
        assert_agents([got["agent"]], want["agent"], f"{ckpt} agent")
        for k in ("env_state", "obs_stack", "buffer"):
            assert_env_close(got[k], want[k], f"{ckpt} full_latest {k}")
        model = torch.load(tmp_path / "ranks" / ckpt / f"model_{steps}",
                           weights_only=True)
        assert_agents([model], want["agent"], f"model_{steps}")


def test_mesh_helpers_without_a_process_group(monkeypatch):
    """What a rank does with its rows needs no collective: rank 1 of 2 over
    8 envs keeps rows 4..7 of every env-leading leaf, draws at global
    width, and leaves other leaves alone; ``mesh=None`` is one process."""
    mesh = pm.Mesh(rank=1, world=2, num_envs=N)
    assert (mesh.local_envs, mesh.lo, mesh.hi) == (4, 4, 8)
    assert not pm.is_main(mesh) and pm.is_main(None)
    with pytest.raises(ValueError, match="mesh=None"):
        pm.Mesh(rank=0, world=1, num_envs=N)
    x = torch.arange(N * 3).reshape(N, 3)
    assert torch.equal(pm.env_rows(x, mesh), x[4:])
    assert pm.env_rows(x, None) is x
    g1, g2 = (torch.Generator().manual_seed(5) for _ in range(2))
    drawn = pm.draw_env_rows(lambda n: torch.rand(n, 2, generator=g1), 4,
                             mesh)
    assert torch.equal(drawn, torch.rand(N, 2, generator=g2)[4:])
    assert torch.equal(g1.get_state(), g2.get_state())
    tree = dict(a=x, pos=torch.tensor(3), w=torch.ones(5, N), n=7,
                rows=[torch.zeros(N, 2, dtype=torch.bool)])
    part = pm.shard_carry(tree, mesh)
    assert torch.equal(part["a"], x[4:]) and part["a"]._base is None
    assert part["pos"] is tree["pos"] and part["w"] is tree["w"]
    assert part["n"] == 7 and part["rows"][0].shape == (4, 2)
    assert torch.equal(pm.shard_carry(dict(a=x), mesh)["a"], x[4:])
    # one process: identities, and no collective is reached
    assert pm.shard_carry(tree, None) is tree
    assert pm.all_reduce_([x], None)[0] is x
    assert pm.gather_rows(x, None) is x
    assert int(pm.offset_of(torch.tensor(3), None)) == 0
    assert pm.agree(True, None) is True
    assert float(pm.global_mean(torch.tensor([1.0, 3.0]), 2, None)) == 2.0
    assert float(pm.mean_over(torch.tensor([1.0, 3.0]), 4, mesh)) == 1.0
    fetched = pm.fetch_to_host(dict(a=x, n=7), None)
    assert torch.equal(fetched["a"], x) and fetched["n"] == 7
    # no launcher in the environment: no process group
    for var in ("RANK", "WORLD_SIZE", "TDE_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    assert not pm.maybe_init_distributed()
    assert not torch.distributed.is_initialized()


def test_make_mesh_refuses_an_indivisible_batch(tmp_path):
    for r in spawn("refuses_indivisible", tmp_path):
        assert r["refused"], "make_mesh(7) over 2 ranks did not refuse"
        assert "does not split over 2 ranks" in r["message"]
    # one process: no mesh, so no collective
    assert pm.make_mesh(N - 1) is None
