"""Training CLI (port of ``torchdriveenv_tpu/rl/train.py``).

Usage:
    python -m torchdriveenv_tpu_torch.rl.train --config_file path/to/config.yml
    python -m torchdriveenv_tpu_torch.rl.train --algorithm sac --total_timesteps 1e5

Loads the YAML schema of the JAX package (``RlTrainingConfig``; the files
under ``examples/env_configs/`` and ``artifacts/*_run.yml`` load unchanged),
builds the fused train step of the chosen algorithm, and runs:
  - periodic evaluation on the validation suite AND the training suite,
    recording the nine benchmark metrics,
  - metric logging to stdout and a JSONL file (and TensorBoard / wandb when
    they import),
  - checkpoints written with ``torch.save``: the small model-only
    ``model_<step>`` (``agent.export_state()``) and the whole carry
    ``full_latest`` (agent and optimizers, env states, frame stacks, the
    replay buffer, the step count and the generator's state), which
    ``--resume_from`` restores so that the run continues the same random
    stream. They are plain containers of tensors and Python scalars, not
    Orbax directories; ``models/convert.py`` carries an agent state between
    the two packages.

The run is on one device: the GPU, or the one ``env.device`` names (``cpu``
for a small run without a GPU). Launched by torchrun, it is data parallel
(``parallel/mesh.py``): ``main`` joins the process group first, each rank
steps its rows of ``parallel_env_num`` envs on its own device and keeps their
part of the replay ring, the learners sum their gradients over the ranks,
and rank 0 alone logs, evaluates, records video and writes checkpoints:

    torchrun --nproc_per_node=N -m torchdriveenv_tpu_torch.rl.train \
        --config_file path/to/config.yml
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from torchdriveenv_tpu_torch.config import (
    BaselineAlgorithm,
    RlTrainingConfig,
    load_rl_training_config,
)
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.env.core import EnvState
from torchdriveenv_tpu_torch.maps.arrays import load_assets, resolve_device
from torchdriveenv_tpu_torch.models.policies import scale_action
from torchdriveenv_tpu_torch.parallel.mesh import (
    Mesh,
    agree,
    fetch_to_host,
    is_main,
    make_mesh,
    maybe_init_distributed,
    shard_carry,
)
from torchdriveenv_tpu_torch.parallel.train_step import (
    make_offpolicy_train_fns,
    make_onpolicy_train_fns,
)
from torchdriveenv_tpu_torch.rl.buffer import ReplayBuffer
from torchdriveenv_tpu_torch.rl.evaluate import make_evaluator
from torchdriveenv_tpu_torch.rl.rollout import RolloutState, init_stack, update_stack
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision
from torchdriveenv_tpu_torch.utils.video import save_video


def _flatten_cfg(cfg, prefix="") -> dict:
    """Flatten the config tree for wandb (``env-*`` / ``env-simulator-*``
    prefixes)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flatten_cfg(v, prefix=f"{prefix}{f.name}-"))
        else:
            out[f"{prefix}{f.name}"] = getattr(v, "value", v)
    return out


def build_agent(algo: BaselineAlgorithm, obs_channels: int,
                algo_kwargs: Optional[dict] = None):
    """-> (agent, on_policy). ``algo_kwargs`` overrides fields of the
    algorithm's config dataclass (e.g. PPO's n_steps / batch_size, which
    shrink and grow with the env count)."""
    kw = dict(algo_kwargs or {})
    if algo == BaselineAlgorithm.sac:
        from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
        return SAC(SACConfig(**kw), obs_channels), False
    if algo == BaselineAlgorithm.td3:
        from torchdriveenv_tpu_torch.rl.td3 import TD3, TD3Config
        return TD3(TD3Config(**kw), obs_channels), False
    if algo == BaselineAlgorithm.ppo:
        from torchdriveenv_tpu_torch.rl.ppo import PPO, PPOConfig
        return PPO(PPOConfig(**kw), obs_channels), True
    if algo == BaselineAlgorithm.a2c:
        from torchdriveenv_tpu_torch.rl.a2c import A2C, A2CConfig
        return A2C(A2CConfig(**kw), obs_channels), True
    raise ValueError(f"unknown algorithm {algo}")


class MetricLogger:
    """stdout + JSONL (+ TensorBoard / wandb when importable) metrics sink.

    The JSONL file and stdout are the record. If the tensorboard or wandb
    package imports, the run is also written there, under ``log_dir`` like
    the rest (wandb offline unless ``WANDB_MODE`` says otherwise); if not,
    those sinks are simply absent.
    """

    def __init__(self, log_dir: str, run_name: str, wandb_config: dict = None,
                 project: str = "torchdriveenv_tpu"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{run_name}.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        self._wandb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(os.path.join(log_dir, run_name))
        except Exception:
            pass
        try:
            import wandb
            self._wandb = wandb.init(
                project=project, name=run_name, dir=log_dir,
                mode=os.environ.get("WANDB_MODE", "offline"),
                config=wandb_config or {})
        except Exception:
            self._wandb = None

    def log(self, step: int, metrics: dict, prefix: str = ""):
        # one device-to-host transfer for the whole dict: a read per scalar
        # is a synchronization each, and a train step reports a dozen
        tensors = {k: v for k, v in metrics.items()
                   if isinstance(v, torch.Tensor)}
        host = {}
        if tensors:
            stacked = torch.stack([v.detach().to(torch.float32).reshape(())
                                   for v in tensors.values()])
            host = dict(zip(tensors, stacked.cpu().tolist()))
        flat = {f"{prefix}{k}": float(host.get(k, v))
                for k, v in metrics.items()}
        self._f.write(json.dumps({"step": step, **flat}) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in flat.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(flat, step=step)
        print(f"[{step}] " + " ".join(f"{k}={v:.4g}" for k, v in flat.items()),
              flush=True)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


class _NullLogger:
    """The metrics sink of ranks other than 0: a data-parallel run must not
    have every rank writing the same JSONL / TensorBoard / wandb streams."""

    path = None

    def log(self, step, metrics, prefix=""):
        pass

    def close(self):
        pass


def _fields(obj) -> Dict[str, Any]:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def carry_to_tree(carry, agent, mesh: Optional[Mesh] = None
                  ) -> Dict[str, Any]:
    """The whole carry as plain containers of tensors and Python scalars.
    With a ``mesh`` the env states, stacks and replay ring of every
    rank are gathered (a collective: call it on every rank) and the tree is
    the one-process carry's, on the host."""
    envs = {"env_state": _fields(carry.rollout.env_state),
            "obs_stack": carry.rollout.obs_stack}
    if hasattr(carry, "buffer"):
        envs["buffer"] = _fields(carry.buffer)
    if mesh is not None:
        envs = fetch_to_host(envs, mesh)
    return {"agent": agent.export_state(), **envs,
            "env_steps": carry.env_steps,
            "generator": carry.generator.get_state()}


def load_carry(carry, agent, tree: Dict[str, Any],
               mesh: Optional[Mesh] = None):
    """Restore ``tree`` (as ``carry_to_tree`` made it) INTO the live carry:
    the agent's modules and optimizers are loaded in place, so the carry's
    ``agent_state`` stays the object the train step updates. With a
    ``mesh`` every rank reads the whole tree and keeps its envs' rows."""
    agent.load_state(tree["agent"])
    tree = {k: (shard_carry(v, mesh) if k in ("env_state", "obs_stack",
                                               "buffer") else v)
            for k, v in tree.items()}
    carry.rollout = RolloutState(EnvState(**tree["env_state"]),
                                 tree["obs_stack"])
    carry.env_steps = int(tree["env_steps"])
    carry.generator.set_state(tree["generator"].cpu())
    if hasattr(carry, "buffer"):
        carry.buffer = ReplayBuffer(**tree["buffer"])
    return carry


def _save(ckpt_dir: str, name: str, tree) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, name))
    torch.save(tree, path)
    return path


def save_checkpoint(ckpt_dir: str, name, carry, agent,
                    mesh: Optional[Mesh] = None) -> Optional[str]:
    """Full-carry checkpoint (agent, optimizers, buffer, env states,
    generator): rare. The replay buffer makes a full off-policy carry
    gigabytes; the frequent artifact is the small ``save_model``. With a
    ``mesh`` every rank takes part in the gather and rank 0 alone
    writes (the others return None); the gather holds the global replay
    ring on every rank's device one field at a time."""
    tree = carry_to_tree(carry, agent, mesh)
    if not is_main(mesh):
        return None
    return _save(ckpt_dir, str(name), tree)


def save_model(ckpt_dir: str, step: int, agent,
               mesh: Optional[Mesh] = None) -> Optional[str]:
    """Model-only save (a few MB): parameters, targets, optimizer moments
    and step counts, as ``agent.export_state()`` gives them. The agent is
    replicated, so rank 0 alone writes it."""
    if not is_main(mesh):
        return None
    return _save(ckpt_dir, f"model_{step}", agent.export_state())


def restore_checkpoint(path: str, device=None):
    """What ``save_checkpoint`` or ``save_model`` wrote, on ``device``."""
    return torch.load(os.path.abspath(path), weights_only=True,
                      map_location=resolve_device(device))


def train(cfg: RlTrainingConfig, resume_from: Optional[str] = None,
          max_wall_s: Optional[float] = None,
          init_model: Optional[str] = None):
    """``resume_from`` restores a FULL carry (same env count and buffer
    shape); ``init_model`` warm-starts only the agent state from a
    model-only save: the cross-scale path (e.g. continue a 10-env policy at
    128 envs, where the carry's shapes differ). Returns the final carry
    (this rank's envs in a data-parallel run)."""
    algo = cfg.algorithm or BaselineAlgorithm.sac
    env_cfg = cfg.env
    device = resolve_device(env_cfg.device)
    set_f32_precision()
    num_envs = cfg.parallel_env_num
    fs = env_cfg.frame_stack
    agent, on_policy = build_agent(algo, obs_channels=3 * fs,
                                   algo_kwargs=cfg.algo_kwargs)
    # data parallel over the process group: each rank steps its rows of the
    # env batch, the learner is replicated, the gradients are summed. One
    # process (or a one-rank group) -> no mesh, and no collective.
    mesh = make_mesh(num_envs)
    main = is_main(mesh)
    if mesh is not None:
        print(f"sharded over {mesh.world} ranks: envs [{mesh.lo}, "
              f"{mesh.hi}) of {num_envs} on rank {mesh.rank}", flush=True)

    run_name = f"{algo.value}-{int(time.time())}"
    if main:
        logger = MetricLogger(cfg.log_dir, run_name,
                              wandb_config=_flatten_cfg(cfg),
                              project=cfg.project)
    else:
        logger = _NullLogger()
    train_assets = load_assets("train", device=device)

    if on_policy:
        init_fn, train_step = make_onpolicy_train_fns(
            env_cfg, agent, num_envs, device=device, mesh=mesh)
        steps_per_iter = agent.cfg.n_steps * num_envs
    else:
        demo_fn = None
        if cfg.demo_warmup_steps or cfg.demo_envs:
            from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
            demo_fn = make_scripted_driver(env_cfg, train_assets)
        init_fn, train_step = make_offpolicy_train_fns(
            env_cfg, agent, num_envs,
            buffer_capacity=max(agent.cfg.buffer_size // num_envs, 256),
            steps_per_iter=cfg.offpolicy_steps_per_iter,
            updates_per_iter=cfg.offpolicy_updates_per_iter,
            demo_fn=demo_fn, demo_steps=cfg.demo_warmup_steps,
            demo_envs=cfg.demo_envs, device=device, mesh=mesh)
        steps_per_iter = cfg.offpolicy_steps_per_iter * num_envs

    carry = init_fn(train_assets,
                    env_cfg.seed if env_cfg.seed is not None else 0)
    if resume_from:
        carry = load_carry(carry, agent, restore_checkpoint(resume_from, device),
                           mesh)
    elif init_model:
        agent.load_state(restore_checkpoint(init_model, device))

    # --- evaluators (rank 0 alone); `deterministic` comes from the
    # callback's config
    eval_gen = torch.Generator(device=device).manual_seed(10_000)

    def act(stack, deterministic):
        out = agent.select_action(stack, eval_gen, deterministic=deterministic)
        return out[0] if isinstance(out, tuple) else out

    def make_eval(assets, n_episodes, deterministic, per_case=False):
        reset_fn, step_fn = make_env_fns(env_cfg, assets, render=True)
        # per_case: round-robin fixed cases, so the log carries
        # eval/success_case_{i} for each named validation case
        cases = n_cases = None
        if per_case:
            n_cases = int(assets.suite.case_town.shape[0])
            n_episodes = max(n_episodes, n_cases)
            cases = np.arange(n_episodes) % n_cases
        ev = make_evaluator(reset_fn, step_fn,
                            lambda _, stack: act(stack, deterministic), fs,
                            scale_action,
                            max_steps=env_cfg.max_environment_steps,
                            cases=cases, n_cases=n_cases)
        return lambda: ev(eval_gen, n_episodes)

    eval_val = eval_train = None
    if main:
        val_assets = load_assets("val", device=device)
        eval_val = make_eval(val_assets,
                             max(cfg.eval_val_callback.eval_n_episodes, 1),
                             cfg.eval_val_callback.deterministic,
                             per_case=True)
        eval_train = make_eval(train_assets,
                               max(cfg.eval_train_callback.eval_n_episodes, 1),
                               cfg.eval_train_callback.deterministic)

    # --- eval video recorder: one validation episode, deterministic
    video_dir = os.path.join(cfg.log_dir, run_name + "_videos")
    record_video = None
    if main and cfg.eval_val_callback.record:
        reset_v, step_v = make_env_fns(env_cfg, val_assets, render=True)

        @torch.no_grad()
        def record_video(step):
            state, obs = reset_v(eval_gen, 1)
            stack = init_stack(obs, fs)
            frames = []
            for _ in range(env_cfg.max_environment_steps):
                o = step_v(state, scale_action(act(stack, True)), eval_gen)
                state = o.state
                stack = update_stack(stack, o.obs, o.terminated | o.truncated)
                frames.append(o.obs[0])
            os.makedirs(video_dir, exist_ok=True)
            save_video(list(torch.stack(frames).cpu().numpy()),
                       os.path.join(video_dir, f"eval_{step}.avi"))

    total = int(cfg.total_timesteps)
    eval_every = max(cfg.eval_val_callback.n_steps, steps_per_iter)
    model_save_every = max(cfg.wandb_callback.model_save_freq, steps_per_iter)
    snapshot_every = (max(cfg.full_snapshot_every, model_save_every)
                      if cfg.full_snapshot_every > 0 else None)
    if cfg.full_snapshot_every < 0:
        print("full snapshots disabled (full_snapshot_every < 0): "
              "--resume_from will have nothing to restore from this run",
              flush=True)
    video_every = eval_every * 10
    log_every_iters = max(1, 1000 // steps_per_iter)
    ckpt_dir = cfg.checkpoint_dir or os.path.join("models", run_name)

    env_steps = carry.env_steps
    next_eval = 0
    next_model = model_save_every
    next_snapshot = snapshot_every if snapshot_every else float("inf")
    next_video = 0
    t_start = time.time()
    iters = 0

    pending_log = None    # (step, device metrics) deferred one iteration
    while env_steps < total:
        # rank 0's clock decides for every rank
        if max_wall_s is not None and agree(
                time.time() - t_start > max_wall_s, mesh):
            print("wall-clock budget reached", flush=True)
            break
        carry, metrics = train_step(train_assets, carry)
        env_steps = carry.env_steps
        iters += 1
        # flush the PREVIOUS iteration's metrics now that the next step is
        # queued: the host read overlaps the train step in flight instead of
        # stalling the device
        if pending_log is not None:
            logger.log(*pending_log, prefix="train/")
            pending_log = None
        if iters % log_every_iters == 0:
            m = dict(metrics)
            m["env_steps_per_s"] = env_steps / (time.time() - t_start)
            pending_log = (env_steps, m)

        if env_steps >= next_eval:
            next_eval = env_steps + eval_every
            if main:
                logger.log(env_steps, eval_val(), prefix="eval/")
                logger.log(env_steps, eval_train(), prefix="eval_train/")
        if record_video is not None and env_steps >= next_video:
            next_video = env_steps + video_every
            record_video(env_steps)
        if env_steps >= next_model:
            next_model = env_steps + model_save_every
            # named per-step model saves (a few MB each): every save is kept
            save_model(ckpt_dir, env_steps, agent, mesh)
        if env_steps >= next_snapshot:
            next_snapshot = env_steps + snapshot_every
            save_model(ckpt_dir, env_steps, agent, mesh)
            save_checkpoint(ckpt_dir, "full_latest", carry, agent, mesh)

    if pending_log is not None:
        logger.log(*pending_log, prefix="train/")
    save_model(ckpt_dir, env_steps, agent, mesh)
    if cfg.full_snapshot_every >= 0:
        save_checkpoint(ckpt_dir, "full_latest", carry, agent, mesh)
    logger.close()
    return carry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config_file", type=str, default=None)
    ap.add_argument("--algorithm", type=str, default=None)
    ap.add_argument("--total_timesteps", type=float, default=None)
    ap.add_argument("--parallel_env_num", type=int, default=None)
    ap.add_argument("--resume_from", type=str, default=None)
    ap.add_argument("--init_model", type=str, default=None,
                    help="warm-start agent state from a model-only save "
                    "(cross-env-count, unlike --resume_from)")
    ap.add_argument("--max_wall_s", type=float, default=None)
    args = ap.parse_args(argv)
    # first: join the process group a launcher (torchrun, SLURM) set up;
    # the group this call joins is destroyed when the run ends (nccl warns
    # of leaked resources at exit otherwise)
    joined = (not torch.distributed.is_initialized()
              and maybe_init_distributed())

    if args.config_file:
        cfg = load_rl_training_config(args.config_file)
    else:
        cfg = RlTrainingConfig()
    if args.algorithm:
        cfg.algorithm = BaselineAlgorithm(args.algorithm)
    if args.total_timesteps is not None:
        cfg.total_timesteps = int(args.total_timesteps)
    if args.parallel_env_num is not None:
        cfg.parallel_env_num = args.parallel_env_num
    carry = train(cfg, resume_from=args.resume_from,
                  max_wall_s=args.max_wall_s, init_model=args.init_model)
    if joined:
        torch.distributed.destroy_process_group()
    return carry


if __name__ == "__main__":
    main()
