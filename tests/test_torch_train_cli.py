"""The port's training CLI (``rl/train.py``) on the CPU, at tiny sizes
(ego-only envs, 20-pixel observations, 5-step episodes; bf16 torsos, the
CLI's only dtype, run under CPU autocast here): all
four algorithms train, evaluate, log and write their checkpoints; the
``full_snapshot_every`` cadences; a run resumed from ``full_latest`` ends
bit-equal to a straight one; ``--init_model`` restores the agent and
nothing else; ``main`` parses its seven flags; the evaluation video.

Nothing here is compared with the JAX package: its CLI writes Orbax
directories and draws from other streams. What both share (configs,
learners, train steps, evaluator) is held to it in the other
``test_torch_*`` files. The TensorBoard sink is switched off (importing it
costs ten seconds here); it is optional in the CLI.
"""

import copy
import dataclasses
import glob
import json
import os
import sys

import pytest
import torch

from torchdriveenv_tpu_torch.config import construct_rl_training_config
from torchdriveenv_tpu_torch.rl import train as train_mod

torch.set_num_threads(2)
ALGOS = ("sac", "td3", "ppo", "a2c")
# steps per train step of the wide (32-env) and the small (2-env) runs
WIDE_KW = dict(
    sac=dict(batch_size=16, learning_starts=0, buffer_size=32 * 64),
    td3=dict(batch_size=16, learning_starts=0, buffer_size=32 * 64),
    ppo=dict(n_steps=16, batch_size=128, n_epochs=1),
    a2c=dict(n_steps=16))
SMALL_KW = dict(
    sac=dict(batch_size=4, learning_starts=4, buffer_size=2 * 300),
    td3=dict(batch_size=4, learning_starts=4, buffer_size=2 * 300),
    ppo=dict(n_steps=4, batch_size=4, n_epochs=2),
    a2c=dict(n_steps=4))
SMALL_STEPS_PER_ITER = dict(sac=4, td3=4, ppo=8, a2c=8)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _cfg(algo, tmp, total, wide=False, **over):
    raw = dict(
        algorithm=algo, parallel_env_num=32 if wide else 2,
        total_timesteps=total,
        algo_kwargs=dict((WIDE_KW if wide else SMALL_KW)[algo]),
        log_dir=os.path.join(str(tmp), "runs"),
        checkpoint_dir=os.path.join(str(tmp), "ckpt"),
        offpolicy_steps_per_iter=16 if wide else 2,
        offpolicy_updates_per_iter=2,
        env=dict(ego_only=True, max_environment_steps=5, device="cpu", seed=3,
                 simulator=dict(renderer=dict(obs_res=20))),
        eval_val_callback=dict(n_steps=10 ** 6, eval_n_episodes=2,
                               record=False),
        eval_train_callback=dict(n_steps=10 ** 6, eval_n_episodes=2),
        wandb_callback=dict(model_save_freq=10 ** 6))
    raw.update(over)
    return construct_rl_training_config(raw)


def _train(cfg, **kw):
    return train_mod.train(cfg, **kw)


def _records(cfg):
    (path,) = glob.glob(os.path.join(cfg.log_dir, "*.jsonl"))
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("algo", ALGOS)
def test_train_logs_evaluates_and_checkpoints(tmp_path, algo):
    """One train step of 512 env steps (32 envs x 16): at that size the
    train metrics are logged every iteration."""
    cfg = _cfg(algo, tmp_path, 512, wide=True)
    carry = _train(cfg)
    assert carry.env_steps == 512
    recs = _records(cfg)
    assert all(r["step"] == 512 for r in recs) and len(recs) == 3
    by_prefix = {next(k for k in r if k != "step").split("/")[0]: r
                 for r in recs}
    assert sorted(by_prefix) == ["eval", "eval_train", "train"]
    agent, _ = train_mod.build_agent(cfg.algorithm, 9, cfg.algo_kwargs)
    assert sorted(by_prefix["train"]) == sorted(
        ["step", "train/mean_step_reward", "train/env_steps_per_s"]
        + [f"train/{k}" for k in agent.metric_names])
    for rec in recs:
        assert all(isinstance(v, (int, float)) and v == v
                   for v in rec.values()), rec
    nine = ("mean_episode_reward", "mean_episode_length", "offroad_rate",
            "collision_rate", "traffic_light_violation_rate",
            "success_percentage", "reached_waypoint_num", "psi_smoothness",
            "speed_smoothness")
    assert sorted(by_prefix["eval_train"]) == sorted(
        ["step"] + [f"eval_train/{k}" for k in nine])
    # the validation suite runs case by case: 5 cases, each at least once
    for i in range(5):
        assert 0.0 <= by_prefix["eval"][f"eval/success_case_{i}"] <= 1.0
    assert 0.0 <= by_prefix["eval"]["eval/success_percentage"] <= 1.0
    assert by_prefix["eval"]["eval/mean_episode_length"] <= 5.0
    assert sorted(os.listdir(cfg.checkpoint_dir)) == ["full_latest",
                                                      "model_512"]
    # the model-only save is the agent's exported state, plain containers
    model = train_mod.restore_checkpoint(
        os.path.join(cfg.checkpoint_dir, "model_512"), "cpu")
    live = carry_agent_export(cfg, carry)
    _assert_trees_equal(model, live, "model_512")
    full = train_mod.restore_checkpoint(
        os.path.join(cfg.checkpoint_dir, "full_latest"), "cpu")
    assert sorted(full) == sorted(
        ["agent", "env_state", "obs_stack", "env_steps", "generator"]
        + (["buffer"] if algo in ("sac", "td3") else []))
    assert full["env_steps"] == 512 and full["generator"].dtype == torch.uint8


def carry_agent_export(cfg, carry):
    """``export_state`` of the agent whose live state the carry holds."""
    agent, _ = train_mod.build_agent(cfg.algorithm, 9, cfg.algo_kwargs)
    agent.state = carry.agent_state
    return agent.export_state()


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), f"{path}: max |diff| " \
            f"{float((a.float() - b.float()).abs().max())}"
    else:
        assert a == b and type(a) is type(b), path


def _carry_tree(cfg, carry):
    agent, _ = train_mod.build_agent(cfg.algorithm, 9, cfg.algo_kwargs)
    agent.state = carry.agent_state
    return train_mod.carry_to_tree(carry, agent)


@pytest.mark.parametrize("algo", ALGOS)
def test_resumed_run_equals_a_straight_one(tmp_path, algo):
    """2N train steps in one run, against N, ``full_latest``, and N more
    with ``--resume_from``: parameters, optimizer moments and counts, env
    states, frame stacks, the replay buffer and the generator's state end
    bit-equal (every op of these runs is deterministic on the CPU)."""
    spi, n = SMALL_STEPS_PER_ITER[algo], 2
    straight = _cfg(algo, tmp_path / "straight", 2 * n * spi)
    want = _carry_tree(straight, _train(straight))
    first = _cfg(algo, tmp_path / "resumed", n * spi)
    half = _carry_tree(first, _train(first))
    assert half["env_steps"] == n * spi
    second = _cfg(algo, tmp_path / "resumed", 2 * n * spi)
    carry = _train(second, resume_from=os.path.join(first.checkpoint_dir,
                                                    "full_latest"))
    got = _carry_tree(second, carry)
    assert got["env_steps"] == 2 * n * spi == carry.env_steps
    _assert_trees_equal(got, want)
    # ... and the second half did train: the agent moved on from the save
    with pytest.raises(AssertionError):
        _assert_trees_equal(got["agent"], half["agent"])
    if algo in ("sac", "td3"):
        assert int(carry.buffer.pos) == 2 * n * 2 and got["agent"]["step"] == 6
        # the optimizers step the live modules' parameters, not orphans
        st = carry.agent_state
        assert all(p in st.critic_opt.state for p in st.critic.parameters())
    else:
        assert got["agent"]["step"] == 2 * n
    assert set(os.listdir(second.checkpoint_dir)) == {
        "full_latest", f"model_{n * spi}", f"model_{2 * n * spi}"}


def test_policy_mode_run_resumes_bit_equal(tmp_path):
    """SAC with the GRU driving the NPCs (traffic on): the hidden state
    goes into ``full_latest`` and back, and a resumed run ends bit-equal to
    a straight one."""
    env = dict(ego_only=False, npc_mode="policy", max_environment_steps=5,
               device="cpu", seed=3, simulator=dict(renderer=dict(obs_res=20)))
    spi = SMALL_STEPS_PER_ITER["sac"]
    straight = _cfg("sac", tmp_path / "straight", 4 * spi, env=env)
    carry = _train(straight)
    hidden = carry.rollout.env_state.npc_hidden
    assert hidden.shape == (2, 96, 16) and hidden.abs().max() > 0
    want = _carry_tree(straight, carry)
    first = _cfg("sac", tmp_path / "resumed", 2 * spi, env=env)
    _train(first)
    full = train_mod.restore_checkpoint(
        os.path.join(first.checkpoint_dir, "full_latest"), "cpu")
    assert full["env_state"]["npc_hidden"].shape == (2, 96, 16)
    second = _cfg("sac", tmp_path / "resumed", 4 * spi, env=env)
    got = _carry_tree(second, _train(
        second, resume_from=os.path.join(first.checkpoint_dir, "full_latest")))
    _assert_trees_equal(got, want)


def test_init_model_restores_the_agent_and_nothing_else(tmp_path):
    first = _cfg("sac", tmp_path / "a", 8)
    trained = _carry_tree(first, _train(first))
    model = os.path.join(first.checkpoint_dir, "model_8")
    # no train step (total_timesteps 0): what comes back is the start
    warm = _cfg("sac", tmp_path / "b", 0)
    got = _carry_tree(warm, _train(warm, init_model=model))
    cold = _cfg("sac", tmp_path / "c", 0)
    fresh = _carry_tree(cold, _train(cold))
    _assert_trees_equal(got["agent"], trained["agent"])
    assert got["agent"]["step"] == 2 and fresh["agent"]["step"] == 0
    for k in ("env_state", "obs_stack", "buffer", "generator", "env_steps"):
        _assert_trees_equal(got[k], fresh[k], k)
    assert got["env_steps"] == 0 and int(got["buffer"]["pos"]) == 0
    # a wall-clock budget of nothing stops before the first train step
    timed = _cfg("sac", tmp_path / "d", 8)
    assert _train(timed, max_wall_s=-1.0).env_steps == 0


@pytest.mark.parametrize("every,saves", [(8, 3), (0, 1), (-1, 0)])
def test_full_snapshot_cadence(tmp_path, monkeypatch, every, saves):
    """> 0: a snapshot every ``max(every, model_save_freq)`` env steps and
    one at the end; 0: the one at the end; < 0: none. Model-only saves keep
    their own cadence."""
    calls = []
    plain = train_mod.save_checkpoint
    monkeypatch.setattr(
        train_mod, "save_checkpoint",
        lambda d, name, carry, agent, mesh=None:
        calls.append(carry.env_steps) or plain(d, name, carry, agent))
    cfg = _cfg("a2c", tmp_path, 16, full_snapshot_every=every,
               wandb_callback=dict(model_save_freq=4))
    _train(cfg)
    assert len(calls) == saves
    assert calls == {8: [8, 16, 16], 0: [16], -1: []}[every]
    files = sorted(os.listdir(cfg.checkpoint_dir))
    assert [f for f in files if f.startswith("model_")] == [
        "model_16", "model_8"]         # every 8 = one train step; sorted as text
    assert ("full_latest" in files) == (every >= 0)


def test_main_parses_its_seven_flags(tmp_path, monkeypatch):
    seen = {}
    monkeypatch.setattr(train_mod, "train",
                        lambda cfg, **kw: seen.update(cfg=cfg, **kw))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    train_mod.main([
        "--config_file", os.path.join(root, "artifacts", "a2c_short_run.yml"),
        "--algorithm", "td3", "--total_timesteps", "2e3",
        "--parallel_env_num", "3", "--resume_from", "some/full_latest",
        "--init_model", "some/model_8", "--max_wall_s", "7.5"])
    cfg = seen["cfg"]
    assert cfg.algorithm.value == "td3" and cfg.total_timesteps == 2000
    assert cfg.parallel_env_num == 3 and cfg.env.seed == 5      # from the file
    assert cfg.env.distance_cutoff == 0.25
    assert seen["resume_from"] == "some/full_latest"
    assert seen["init_model"] == "some/model_8" and seen["max_wall_s"] == 7.5
    train_mod.main([])
    assert dataclasses.asdict(seen["cfg"]) == dataclasses.asdict(
        train_mod.RlTrainingConfig())
    assert seen["resume_from"] is None and seen["max_wall_s"] is None
    with pytest.raises(SystemExit):
        train_mod.main(["--no_such_flag"])


def test_the_cli_defaults_to_the_gpu(tmp_path):
    """No ``env.device``: the run is for the card, and says so without one."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    cfg = _cfg("ppo", tmp_path, 8)
    cfg.env.device = None
    with pytest.raises(RuntimeError, match="CUDA"):
        train_mod.train(cfg)


def test_eval_video_is_written(tmp_path):
    pytest.importorskip("PIL")
    cfg = _cfg("a2c", tmp_path, 8)
    cfg.eval_val_callback.record = True
    _train(cfg)
    (video,) = glob.glob(os.path.join(cfg.log_dir, "*_videos", "eval_8.avi"))
    with open(video, "rb") as f:
        head = f.read(12)
    assert head[:4] == b"RIFF" and head[8:] == b"AVI "
    assert os.path.getsize(video) > 5 * 300         # 5 JPEG frames of 20 x 20


def test_metric_logger_reads_the_device_once(tmp_path):
    logger = train_mod.MetricLogger(str(tmp_path), "run")
    logger.log(7, {"a": torch.tensor(1.5), "b": 2, "c": torch.tensor(3)},
               prefix="train/")
    logger.close()
    with open(os.path.join(str(tmp_path), "run.jsonl")) as f:
        assert json.loads(f.read()) == {"step": 7, "train/a": 1.5,
                                        "train/b": 2.0, "train/c": 3.0}
    flat = train_mod._flatten_cfg(_cfg("sac", tmp_path, 8))
    assert flat["algorithm"] == "sac" and flat["env-ego_only"] is True
    assert flat["env-simulator-renderer-obs_res"] == 20
    assert copy.deepcopy(flat) == flat
