"""The port's checkpoint evaluation: ``examples/evaluate_policy.py`` and
``tools/eval_checkpoints.py``, on checkpoints written by a tiny
``rl.train.train`` run on the CPU.

``evaluate`` gives identical metrics for a ``model_*`` and for the
``full_latest`` of the same agent, and those equal ``rl/evaluate.py``'s
evaluator run directly with that agent (same seed, cases pinned round-robin
to the 5 validation cases); the nine metrics and ``success_case_0..4`` are
there. The same checkpoint, carried into the JAX package by
``convert.sac_state_from_torch``, gives the JAX tool's
``examples/evaluate_policy.evaluate`` the same metrics within 1e-6: both
tools pin the episodes round-robin to the cases, act deterministically and
scale the actions, and the port's resets are the JAX tool's own, handed
over. ``eval_checkpoints`` orders the checkpoints by step, honours
``--last_n`` and writes its rows as JSON.
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from examples import evaluate_policy as jev
from test_torch_sac import _jax_state
from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
from torchdriveenv_tpu.env import core as jcore
from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu.rl import sac as jsac
from torchdriveenv_tpu_torch.config import (
    BaselineAlgorithm,
    EnvConfig,
    construct_rl_training_config,
)
from torchdriveenv_tpu_torch.env import batched as tbatched
from torchdriveenv_tpu_torch.env import core as tcore
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.examples import evaluate_policy
from torchdriveenv_tpu_torch.maps.arrays import load_assets
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.models.policies import scale_action
from torchdriveenv_tpu_torch.rl import train as train_mod
from torchdriveenv_tpu_torch.rl.evaluate import make_evaluator
from torchdriveenv_tpu_torch.rl.sac import SAC
from torchdriveenv_tpu_torch.tools import eval_checkpoints

torch.set_num_threads(2)
NINE = ("mean_episode_reward", "mean_episode_length", "offroad_rate",
        "collision_rate", "traffic_light_violation_rate",
        "success_percentage", "reached_waypoint_num", "psi_smoothness",
        "speed_smoothness")
HORIZON = 6


def _env_cfg():
    return EnvConfig(max_environment_steps=HORIZON, device="cpu")


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A SAC run of 3 train steps x 8 env steps (updates from the second),
    its ``model_24`` and ``full_latest``."""
    tmp = tmp_path_factory.mktemp("run")
    cfg = construct_rl_training_config(dict(
        algorithm="sac", parallel_env_num=2, total_timesteps=24,
        offpolicy_steps_per_iter=4, offpolicy_updates_per_iter=1,
        algo_kwargs=dict(learning_starts=8, batch_size=4),
        log_dir=os.path.join(str(tmp), "runs"),
        checkpoint_dir=os.path.join(str(tmp), "ckpt"),
        env=dict(max_environment_steps=HORIZON, device="cpu", seed=3),
        eval_val_callback=dict(n_steps=10 ** 6, eval_n_episodes=1,
                               record=False),
        eval_train_callback=dict(n_steps=10 ** 6, eval_n_episodes=1),
        wandb_callback=dict(model_save_freq=10 ** 6)))
    saved = sys.modules.get("torch.utils.tensorboard")
    sys.modules["torch.utils.tensorboard"] = None
    try:
        carry = train_mod.train(cfg)
    finally:
        sys.modules.pop("torch.utils.tensorboard")
        if saved is not None:
            sys.modules["torch.utils.tensorboard"] = saved
    assert carry.env_steps == 24 and carry.agent_state.step == 2
    return cfg.checkpoint_dir


def _evaluate(path, episodes=5, **kw):
    return evaluate_policy.evaluate(path, "sac", episodes, "val",
                                    env_cfg=_env_cfg(), device="cpu", **kw)


@pytest.fixture(scope="module")
def model_metrics(run_dir):
    return _evaluate(os.path.join(run_dir, "model_24"))


def test_model_and_full_checkpoints_evaluate_alike(run_dir, model_metrics):
    full = _evaluate(os.path.join(run_dir, "full_latest"),
                     full_checkpoint=True)
    assert full == model_metrics


def test_the_metrics_are_the_evaluators(run_dir, model_metrics):
    """The evaluator of ``rl/evaluate.py`` driven by hand with the agent the
    checkpoint holds, as ``evaluate`` documents it."""
    cfg = _env_cfg()
    agent, _ = train_mod.build_agent(BaselineAlgorithm.sac, obs_channels=9)
    agent.init(device="cpu")
    agent.load_state(torch.load(os.path.join(run_dir, "model_24"),
                                weights_only=True))
    assets = load_assets("val", device="cpu")
    reset_fn, step_fn = make_env_fns(cfg, assets, render=True)
    g = torch.Generator().manual_seed(evaluate_policy.EVAL_SEED)
    ev = make_evaluator(
        reset_fn, step_fn,
        lambda _, stack: agent.select_action(stack, g, deterministic=True),
        3, scale_action, max_steps=HORIZON, cases=np.arange(5) % 5, n_cases=5)
    want = {k: float(v) for k, v in ev(g, 5).items()}
    assert model_metrics == want


@pytest.mark.parametrize("episodes", [3, 7])
def test_evaluate_matches_the_jax_tool(run_dir, episodes, monkeypatch):
    """3 episodes become one per case; 7 wrap round-robin onto cases 0, 1.
    Both agents act in f32 (the tools' default torsos are bf16, whose
    convolutions differ between the packages by more than 1e-6)."""
    path = os.path.join(run_dir, "model_24")
    jstate = _jax_state(convert.sac_state_from_torch(
        torch.load(path, weights_only=True)))
    jagent = jsac.SAC(jsac.SACConfig(), 9)
    jagent.actor = jpol.SquashedGaussianActor(compute_dtype=jnp.float32)
    monkeypatch.setattr(jev, "build_agent", lambda algo, obs_channels: (
        jagent, False))
    monkeypatch.setattr(jev, "load_agent_state", lambda *a: jstate)
    want = jev.evaluate(path, "sac", episodes, "val",
                        env_cfg=JEnvConfig(max_environment_steps=HORIZON))

    # the JAX tool's resets: its keys and its round-robin cases
    n = max(episodes, 5)
    cases = np.arange(n) % 5
    jcfg = JEnvConfig(max_environment_steps=HORIZON)
    jassets = jev.load_assets("val")
    keys = jax.random.split(jax.random.PRNGKey(evaluate_policy.EVAL_SEED), n)
    handed = tcore.EnvState.from_numpy(jax.tree.map(np.asarray, jax.jit(
        jax.vmap(lambda k, c: jcore.reset(jcfg, jassets, k, case=c)))(
            keys, jnp.asarray(cases, jnp.int32))), device="cpu")
    seen = []

    def handed_env_fns(cfg, assets, render=True):
        _, step_fn = tbatched.make_env_fns(cfg, assets, render=render)

        def reset_fn(generator, num_envs, cases=None):
            seen.append(cases.tolist())
            return handed, tbatched._obs_batched(cfg, assets, handed)
        return reset_fn, step_fn

    monkeypatch.setattr(evaluate_policy, "make_env_fns", handed_env_fns)
    monkeypatch.setattr(evaluate_policy, "build_agent",
                        lambda algo, obs_channels: (
                            SAC(compute_dtype=torch.float32), False))
    got = _evaluate(path, episodes=episodes)
    assert seen == [cases.tolist()]
    keys = NINE + tuple(f"success_case_{i}" for i in range(5)) + tuple(
        f"reached_case_{i}" for i in range(5))
    assert sorted(got) == sorted(want) and set(keys) <= set(got)
    for k in keys:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


def test_the_report_has_every_metric(model_metrics):
    for k in NINE + tuple(f"success_case_{i}" for i in range(5)) + tuple(
            f"reached_case_{i}" for i in range(5)):
        assert k in model_metrics, k
        assert np.isfinite(model_metrics[k]), k
    assert model_metrics["mean_episode_length"] <= HORIZON
    assert 0.0 <= model_metrics["success_percentage"] <= 1.0


def test_the_agent_state_is_the_checkpoints(run_dir):
    agent, _ = train_mod.build_agent(BaselineAlgorithm.sac, obs_channels=9)
    tree = torch.load(os.path.join(run_dir, "full_latest"), weights_only=True)
    st = evaluate_policy.load_agent_state(
        os.path.join(run_dir, "full_latest"), agent, _env_cfg(),
        full_checkpoint=True)
    assert st is agent.state and st.step == tree["agent"]["step"] == 2
    for k, v in st.critic.state_dict().items():
        assert torch.equal(v, tree["agent"]["critic"][k]), k


def test_evaluate_needs_a_gpu_or_device_cpu(run_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_policy.evaluate(os.path.join(run_dir, "model_24"))


def test_eval_checkpoints_orders_by_step_and_writes_rows(tmp_path,
                                                         monkeypatch):
    for step in (100, 2, 10):
        (tmp_path / f"model_{step}").write_bytes(b"")
    (tmp_path / "full_latest").write_bytes(b"")
    seen = []

    def fake(path, algorithm, episodes, suite, env_cfg=None, device=None):
        seen.append(os.path.basename(path))
        step = int(path.rsplit("_", 1)[1])
        return dict(success_percentage=step / 100, reached_waypoint_num=1.0,
                    mean_episode_length=5.0,
                    **{f"success_case_{i}": 0.5 for i in range(5)})

    monkeypatch.setattr(eval_checkpoints, "evaluate", fake)
    rows = eval_checkpoints.main(["--ckpt_dir", str(tmp_path),
                                  "--device", "cpu"])
    assert seen == ["model_2", "model_10", "model_100"]
    assert [r["step"] for r in rows] == [2, 10, 100]
    seen.clear()
    out = str(tmp_path / "sweep.json")
    rows = eval_checkpoints.main(["--ckpt_dir", str(tmp_path), "--last_n",
                                  "2", "--device", "cpu", "--out", out])
    assert seen == ["model_10", "model_100"]
    with open(out) as f:
        assert json.load(f) == rows
    assert rows[1] == dict(checkpoint="model_100", step=100,
                           success_percentage=1.0, reached_waypoint_num=1.0,
                           mean_episode_length=5.0,
                           **{f"success_case_{i}": 0.5 for i in range(5)})


def test_eval_checkpoints_evaluates_the_checkpoints(run_dir, tmp_path):
    for step in (8, 24):
        shutil.copy(os.path.join(run_dir, "model_24"),
                    tmp_path / f"model_{step}")
    rows = eval_checkpoints.main(["--ckpt_dir", str(tmp_path), "--episodes",
                                  "5", "--last_n", "1", "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["checkpoint"] == "model_24"
    want = evaluate_policy.evaluate(os.path.join(run_dir, "model_24"),
                                    episodes=5, device="cpu")
    assert {k: v for k, v in rows[0].items()
            if k not in ("checkpoint", "step")} == want
