"""Data parallelism at world 4 on the CPU: the training CLI's ``train``
(``rl/train.py``) under four gloo ranks against one process.

Four ranks (``python tests/test_torch_mesh4.py <case> <rank> <store>``, the
ranks meeting through ``init_method=file://<store>`` as in
``tests/test_torch_mesh.py``) run the case ``cli``, on 16 envs (4 a rank),
learners in f32:

  - ``ppo``: 2 PPO train steps, pooled resets (a pool of 8 consumed in
    global rank order over the four ranks);
  - ``sac``: 2 SAC train steps (the first warms up); its ``full_latest`` is
    the resume point;
  - ``sac_resumed``: one more train step resumed from ``sac``'s
    ``full_latest`` at world 4;
  - ``sac_evals``: the same 3 train steps without a break, rank 0
    evaluating after every one of them while ranks 1-3 wait in their next
    collective.

The test process runs ``ppo`` and ``sac`` with no process group, and resumes
the world-4 ``full_latest`` of ``sac`` in one process. The case
``small_batches`` takes SAC train steps on batches of 2 rows, so that a
rank owns none of some batches' rows. Agents are held
bit-equal over the ranks and to one process at the Adam-parity tolerance of
``tests/test_torch_sac.py``; env states, frame stacks and the replay ring at
the golden tolerance (ints exact); each train step's metrics at rtol 1e-4 /
atol 1e-5.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torchdriveenv_tpu_torch.config import construct_rl_training_config  # noqa: E402
from torchdriveenv_tpu_torch.parallel import mesh as pm  # noqa: E402

N = 16                  # global envs: 4 per rank
WORLD = 4
WORKER_TIMEOUT_S = 150
SAC_STEP = 2 * N        # env steps in a SAC train step (2 per env)
PPO_STEP = 4 * N        # env steps in a PPO train step (4 per env)


def config(out_dir, name, total, eval_every=10 ** 6):
    """The run ``name`` (``ppo``, or a SAC run) of ``total`` env steps,
    writing under ``<out_dir>/<name>``; an evaluation after the first train
    step and then every ``eval_every`` env steps, on rank 0."""
    return construct_rl_training_config(
        raw_config(out_dir, name, total, eval_every))


def raw_config(out_dir, name, total, eval_every=10 ** 6):
    """``config``'s tree, as a YAML file holds it."""
    raw = dict(
        algorithm="ppo" if name == "ppo" else "sac", parallel_env_num=N,
        total_timesteps=total, log_dir=os.path.join(out_dir, name, "runs"),
        checkpoint_dir=os.path.join(out_dir, name, "ckpt"),
        env=dict(ego_only=True, max_environment_steps=5, device="cpu", seed=3,
                 reset_pool=8, simulator=dict(renderer=dict(obs_res=20))),
        eval_val_callback=dict(n_steps=eval_every, eval_n_episodes=2,
                               record=False),
        eval_train_callback=dict(n_steps=eval_every, eval_n_episodes=2),
        wandb_callback=dict(model_save_freq=10 ** 6))
    if name == "ppo":
        raw["algo_kwargs"] = dict(n_steps=4, batch_size=16, n_epochs=2)
    else:
        raw.update(algo_kwargs=dict(batch_size=16, learning_starts=16,
                                    buffer_size=N * 64),
                   offpolicy_steps_per_iter=2, offpolicy_updates_per_iter=2)
    return raw


def run(out_dir, name, total, **kw):
    """``rl.train.train`` of the run ``name`` with the learner in f32 ->
    {agent: its state after the run, saved: the checkpoints this process
    wrote, metrics: each train step's}."""
    from torchdriveenv_tpu_torch.rl import train as train_mod
    plain_build, plain_save = train_mod.build_agent, train_mod._save
    factories = ("make_onpolicy_train_fns", "make_offpolicy_train_fns")
    plain_fns = {f: getattr(train_mod, f) for f in factories}
    tensorboard = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None   # a 10 s import here
    built, saved, metrics = [], [], []

    def build_f32(*a, **k):
        agent, on_policy = plain_build(*a, **k)
        agent.compute_dtype = torch.float32
        built.append(agent)
        return agent, on_policy

    def save(ckpt_dir, ckpt, tree):
        saved.append(ckpt)
        return plain_save(ckpt_dir, ckpt, tree)

    def recorded(factory):
        def make(*a, **k):
            init_fn, step_fn = factory(*a, **k)

            def step(assets, carry):
                carry, m = step_fn(assets, carry)
                metrics.append({k: float(v) for k, v in m.items()})
                return carry, m
            return init_fn, step
        return make

    train_mod.build_agent, train_mod._save = build_f32, save
    for f in factories:
        setattr(train_mod, f, recorded(plain_fns[f]))
    try:
        cfg = config(out_dir, name, total, **kw.pop("cfg", {}))
        train_mod.train(cfg, **kw)
    finally:
        train_mod.build_agent, train_mod._save = plain_build, plain_save
        for f in factories:
            setattr(train_mod, f, plain_fns[f])
        if tensorboard is None:
            del sys.modules["torch.utils.tensorboard"]
        else:
            sys.modules["torch.utils.tensorboard"] = tensorboard
    return dict(agent=built[0].export_state(), saved=saved, metrics=metrics)


def small_batches(mesh):
    """Two SAC train steps (``tests/test_torch_mesh.py``'s 8 envs, 2 a
    rank) of updates on batches of 2 rows, so that a rank owns none of the
    rows of some batches -> the step's result and each sample's row count
    on this rank."""
    from test_torch_mesh import _train_steps
    from torchdriveenv_tpu_torch.rl import buffer as replay
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    plain, rows = replay.sample, []

    def sample(*a, **k):
        batch = plain(*a, **k)
        rows.append(int(batch["pos"].numel()))
        return batch

    replay.sample = sample
    try:
        out = _train_steps(mesh, SAC(SACConfig(batch_size=2, learning_starts=0),
                                     compute_dtype=torch.float32),
                           True, n_steps=2)
    finally:
        replay.sample = plain
    return dict(out, rows=rows)


def ranks_runs(out_dir):
    """What every rank runs, in order."""
    sac_ckpt = os.path.join(out_dir, "sac", "ckpt", "full_latest")
    return dict(
        ppo=run(out_dir, "ppo", 2 * PPO_STEP),
        sac=run(out_dir, "sac", 2 * SAC_STEP),
        sac_resumed=run(out_dir, "sac_resumed", 3 * SAC_STEP,
                        resume_from=sac_ckpt),
        sac_evals=run(out_dir, "sac_evals", 3 * SAC_STEP,
                      cfg=dict(eval_every=SAC_STEP)))


def cli_main(store):
    """The CLI's ``main`` as torchrun starts it: the process group joined
    from the launcher's variables, 2 PPO train steps from a YAML file ->
    whether a process group is left when ``main`` returns."""
    import yaml
    from torchdriveenv_tpu_torch.rl import train as train_mod
    out_dir = os.path.dirname(store)
    path = os.path.join(out_dir, f"main_rank{os.environ['RANK']}.yml")
    with open(path, "w") as f:
        yaml.safe_dump(raw_config(out_dir, "ppo", 2 * PPO_STEP), f)
    sys.modules["torch.utils.tensorboard"] = None   # a 10 s import here
    train_mod.main(["--config_file", path])
    return dict(group_left=torch.distributed.is_initialized())


CASES = dict(cli=lambda store: ranks_runs(os.path.dirname(store)),
             small_batches=lambda store: small_batches(pm.make_mesh(8)),
             main=cli_main)


def worker(name, rank, store):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    if name != "main":      # main joins from MASTER_ADDR / MASTER_PORT
        assert pm.maybe_init_distributed(backend="gloo",
                                         init_method=f"file://{store}",
                                         timeout_s=90)
    try:
        out = CASES[name](store)
        torch.save(out, f"{store}.rank{rank}")
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def spawn(name, tmp_path, attempts=2):
    """The four ranks of case ``name`` -> (their directory, each rank's
    result). A run whose
    ranks never met (gloo's TCP set-up failed before any code under test
    ran) is started once more in a fresh directory."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])))
    for attempt in range(attempts):
        if name == "main":
            env.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()))
        run_dir = tmp_path / f"{name}{attempt}"
        run_dir.mkdir()
        store = str(run_dir / "store")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), name, str(r), store],
            env=env, cwd=str(run_dir), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
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
            return run_dir, [torch.load(f"{store}.rank{r}",
                                        weights_only=False)
                             for r in range(WORLD)]
        if not all("connectFullMesh failed" in out for _, _, out in failed):
            break
    raise AssertionError("\n".join(f"rank {r} exited {rc}:\n{out[-3000:]}"
                                    for r, rc, out in failed))


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    sys.exit(0)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

import pytest  # noqa: E402

from test_torch_mesh import assert_agents, assert_env_close  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' runs, and the one-process runs beside them."""
    tmp = tmp_path_factory.mktemp("mesh4")
    ranks_dir, ranks = spawn("cli", tmp)
    one_dir = tmp / "one"
    sac_ckpt = os.path.join(ranks_dir, "sac", "ckpt", "full_latest")
    one = dict(ppo=run(str(one_dir), "ppo", 2 * PPO_STEP),
               sac=run(str(one_dir), "sac", 2 * SAC_STEP),
               # the world-4 resume point, resumed in one process
               sac_resumed=run(str(one_dir), "sac_resumed", 3 * SAC_STEP,
                               resume_from=sac_ckpt))
    return dict(ranks_dir=str(ranks_dir), ranks=ranks, one_dir=str(one_dir),
                one=one)


def full_latest(run_dir, name):
    return torch.load(os.path.join(run_dir, name, "ckpt", "full_latest"),
                      weights_only=True)


def eval_records(run_dir, name):
    """The ``eval/`` records of the run's JSONL file (rank 0's)."""
    logs = os.path.join(run_dir, name, "runs")
    (path,) = [f for f in os.listdir(logs) if f.endswith(".jsonl")]
    with open(os.path.join(logs, path)) as f:
        records = [json.loads(line) for line in f]
    return [r for r in records if any(k.startswith("eval/") for k in r)]


def assert_carry_close(got, want, where):
    """Two ``full_latest`` trees: the same step count and generator, the
    agents Adam-close, the env rows at the golden tolerance."""
    assert sorted(got) == sorted(want), where
    assert got["env_steps"] == want["env_steps"], where
    assert torch.equal(got["generator"], want["generator"]), where
    assert_agents([got["agent"]], want["agent"], f"{where} agent")
    for k in ("env_state", "obs_stack", "buffer"):
        if k in want:
            assert_env_close(got[k], want[k], f"{where} {k}")


def test_four_rank_sac_with_a_rank_owning_no_rows(tmp_path):
    """A rank that owns none of a sampled batch's rows takes part in the
    update with an empty batch (it crashed in the frame-stack gather), and
    the four ranks still take the one-process steps."""
    _, ranks = spawn("small_batches", tmp_path)
    one = small_batches(None)
    assert any(0 in r["rows"] for r in ranks), "no rank owned 0 rows"
    for i in range(len(one["rows"])):
        assert sum(r["rows"][i] for r in ranks) == one["rows"][i] == 2
    assert_agents([r["agent"] for r in ranks], one["agent"], "small batches")
    for r in ranks:
        assert torch.equal(r["generator"], one["generator"])
        assert_env_close(r["envs"], one["envs"], "small batches")
        for g, w in zip(r["metrics"], one["metrics"]):
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"small batches: {k}")


@pytest.mark.parametrize("name", ["ppo", "sac"])
def test_four_rank_cli_equals_one_process(runs, name):
    """Two train steps of the CLI at world 4: the agents bit-equal on the
    ranks and Adam-close to one process, the gathered carry and the logged
    train metrics equal to one process's."""
    assert_agents([r[name]["agent"] for r in runs["ranks"]],
                  runs["one"][name]["agent"], name)
    assert_carry_close(full_latest(runs["ranks_dir"], name),
                       full_latest(runs["one_dir"], name), name)
    for r in runs["ranks"]:
        got, want = r[name]["metrics"], runs["one"][name]["metrics"]
        assert len(got) == len(want) == 2, name
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w), name
            for k in w:
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5,
                                           err_msg=f"{name}: {k}")
    # the learner moved: the last step's losses are not warm-up zeros
    assert any(v != 0 for k, v in want[-1].items() if "loss" in k)


def test_four_rank_cli_writes_checkpoints_once(runs):
    """``model_*`` and ``full_latest`` come from rank 0 alone, one of each
    at the end of every run."""
    steps = dict(ppo=2 * PPO_STEP, sac=2 * SAC_STEP,
                 sac_resumed=3 * SAC_STEP, sac_evals=3 * SAC_STEP)
    for name, n in steps.items():
        assert runs["ranks"][0][name]["saved"] == [f"model_{n}",
                                                  "full_latest"], name
        for r in runs["ranks"][1:]:
            assert r[name]["saved"] == [], f"{name}: a rank > 0 wrote"
        ckpt = os.path.join(runs["ranks_dir"], name, "ckpt")
        assert sorted(os.listdir(ckpt)) == ["full_latest", f"model_{n}"]
        model = torch.load(os.path.join(ckpt, f"model_{n}"),
                           weights_only=True)
        assert_agents([model], runs["ranks"][0][name]["agent"], name)


def test_four_rank_resume_equals_the_unbroken_run(runs):
    """Resumed at world 4 from the world-4 ``full_latest``, one train step
    takes the run without a break to the same carry, bit for bit."""
    got = full_latest(runs["ranks_dir"], "sac_resumed")
    want = full_latest(runs["ranks_dir"], "sac_evals")
    assert got["env_steps"] == want["env_steps"] == 3 * SAC_STEP
    for (k, g), (k2, w) in zip(_flat(got), _flat(want)):
        assert k == k2
        assert (torch.equal(g, w) if isinstance(w, torch.Tensor)
                else g == w), f"resumed at world 4: {k}"
    for r in runs["ranks"]:
        assert_agents([r["sac_resumed"]["agent"]], r["sac_evals"]["agent"],
                      "resumed at world 4")


def test_one_process_resumes_a_four_rank_checkpoint(runs):
    """The world-4 ``full_latest`` resumed in one process: its next train
    step equals the four ranks' run without a break."""
    got = full_latest(runs["one_dir"], "sac_resumed")
    want = full_latest(runs["ranks_dir"], "sac_evals")
    assert_carry_close(got, want, "resumed in one process")
    assert_agents([runs["one"]["sac_resumed"]["agent"]],
                  runs["ranks"][0]["sac_evals"]["agent"],
                  "resumed in one process")


def test_four_rank_run_across_evaluations_finishes(runs):
    """Rank 0 evaluated after each of the three train steps while the
    other ranks waited in their next collective; the run finished on every
    rank and its learner is the one of the run that evaluated once."""
    evals = eval_records(runs["ranks_dir"], "sac_evals")
    assert [r["step"] for r in evals] == [SAC_STEP, 2 * SAC_STEP,
                                          3 * SAC_STEP]
    once = eval_records(runs["ranks_dir"], "sac")
    assert [r["step"] for r in once] == [SAC_STEP]
    assert all(np.isfinite(v) for r in evals for v in r.values())
    assert len(runs["ranks"]) == WORLD


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


def test_cli_main_under_four_ranks_leaves_no_process_group(tmp_path):
    """``main`` joins the group from torchrun's variables, trains, has
    rank 0 alone write its checkpoints, and destroys the group it joined
    before it returns (nccl warns of leaked resources at exit otherwise)."""
    run_dir, ranks = spawn("main", tmp_path)
    assert [r["group_left"] for r in ranks] == [False] * WORLD
    ckpt = os.path.join(run_dir, "ppo", "ckpt")
    assert sorted(os.listdir(ckpt)) == ["full_latest",
                                        f"model_{2 * PPO_STEP}"]
