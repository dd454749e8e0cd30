"""Fused training steps (port of ``torchdriveenv_tpu/parallel/train_step.py``).

Off-policy (SAC, TD3): one call steps every env ``steps_per_iter`` times,
appends the transitions to the replay buffer, and then runs
``updates_per_iter`` gradient updates on sampled batches. On-policy (PPO,
A2C): one call collects ``n_steps`` per env into time-major tensors and then
runs the agent's whole update on them. All on one device, with no host read
in between.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import Assets, resolve_device
from torchdriveenv_tpu_torch.models.policies import scale_action, unscale_action
from torchdriveenv_tpu_torch.rl import buffer as replay
from torchdriveenv_tpu_torch.rl.ppo import bootstrap_truncated_rewards
from torchdriveenv_tpu_torch.rl.rollout import RolloutState, init_stack, update_stack


def _check_device(assets: Assets, dev: torch.device) -> None:
    if assets.device.type != dev.type:
        raise ValueError(f"assets are on {assets.device}, the train step "
                         f"on {dev}")


def _first_reset(env_cfg: EnvConfig, assets: Assets, num_envs: int, seed: int):
    """A generator on the assets' device seeded with ``seed``, and the first
    reset of every env drawn from it -> (generator, env_state, obs)."""
    generator = torch.Generator(device=assets.device)
    generator.manual_seed(seed)
    reset_fn, _ = make_env_fns(env_cfg, assets, render=True)
    env_state, obs = reset_fn(generator, num_envs)
    return generator, env_state, obs


@dataclasses.dataclass
class OffPolicyCarry:
    rollout: RolloutState
    buffer: replay.ReplayBuffer
    agent_state: Any                # the agent's own state (agent.state)
    generator: torch.Generator      # on the envs' device
    env_steps: int                  # total env steps taken


def make_offpolicy_train_fns(env_cfg: EnvConfig, agent, num_envs: int,
                             buffer_capacity: int = 10_000,
                             steps_per_iter: int = 1,
                             updates_per_iter: int = 1,
                             demo_fn: Optional[Callable] = None,
                             demo_steps: int = 0, demo_envs: int = 0,
                             device=None) -> Tuple[Callable, Callable]:
    """Build (init_fn, train_step_fn) for an off-policy agent (SAC, TD3).

    init_fn(assets, seed) -> OffPolicyCarry
    train_step_fn(assets, carry) -> (carry, metrics)

    Each train step: ``steps_per_iter`` lockstep env steps appended to the
    replay buffer, then ``updates_per_iter`` gradient updates on sampled
    batches. The carry's buffer and agent are updated in place.

    SB3 warmup semantics (``learning_starts``): while the total env steps
    are below it, actions are drawn uniformly from the action space and no
    gradient update runs; decided once per train step, before its env steps.

    ``demo_fn`` (optional): scripted state-based driver (rl/demo.py); while
    the total env steps are below ``demo_steps``, actions come from it
    instead of the policy, seeding the buffer with demonstrations (updates
    still start at learning_starts). ``demo_envs`` additionally keeps the
    first K envs scripted for the whole run.

    ``device=None`` means the GPU; the assets must be on the same device.
    """
    dev = resolve_device(device)
    fs = env_cfg.frame_stack
    res = env_cfg.simulator.renderer.obs_res

    def init_fn(assets: Assets, seed: int = 0) -> OffPolicyCarry:
        _check_device(assets, dev)
        generator, env_state, obs = _first_reset(env_cfg, assets, num_envs,
                                                 seed)
        buf = replay.create(num_envs, buffer_capacity, (3, res, res),
                            device=assets.device)
        agent_state = agent.init(seed=seed, obs_res=res, device=assets.device)
        return OffPolicyCarry(
            rollout=RolloutState(env_state, init_stack(obs, fs)),
            buffer=buf, agent_state=agent_state, generator=generator,
            env_steps=0)

    def train_step_fn(assets: Assets, carry: OffPolicyCarry
                      ) -> Tuple[OffPolicyCarry, Dict[str, torch.Tensor]]:
        _check_device(assets, dev)
        _, step_fn = make_env_fns(env_cfg, assets, render=True,
                                  with_final_obs=True)
        g = carry.generator
        warmup = carry.env_steps < agent.cfg.learning_starts
        demo_mask = None
        if demo_fn is not None:
            demo_phase = carry.env_steps < demo_steps
            demo_mask = (torch.arange(num_envs, device=assets.device)
                         < (num_envs if demo_phase else demo_envs))

        rs, buf = carry.rollout, carry.buffer
        rewards = []
        for _ in range(steps_per_iter):
            with torch.no_grad():
                if warmup:
                    a = torch.rand((num_envs, 2), generator=g,
                                   device=assets.device) * 2.0 - 1.0
                else:
                    a = agent.select_action(rs.obs_stack, g)
                if demo_fn is not None:
                    a_demo = torch.clamp(
                        unscale_action(demo_fn(rs.env_state)), -1.0, 1.0)
                    a = torch.where(demo_mask[:, None], a_demo, a)
                out = step_fn(rs.env_state, scale_action(a), g)
                done = out.terminated | out.truncated
                cur_frame = rs.obs_stack[:, -3:]
                buf = replay.add(buf, cur_frame, a, out.reward, done,
                                 out.terminated, out.final_obs,
                                 demo_mask=demo_mask)
                rs = RolloutState(out.state,
                                  update_stack(rs.obs_stack, out.obs, done))
            rewards.append(out.reward)

        if warmup:
            zero = torch.zeros((), device=assets.device)
            metrics = {k: zero for k in agent.metric_names}
        else:
            rows = []
            for _ in range(updates_per_iter):
                batch = replay.sample(buf, agent.cfg.batch_size, fs,
                                      generator=g)
                rows.append(agent.update(batch, generator=g))
            metrics = {k: torch.stack([r[k] for r in rows]).mean()
                       for k in rows[0]}
        metrics["mean_step_reward"] = torch.stack(rewards).mean()

        new_carry = OffPolicyCarry(
            rollout=rs, buffer=buf, agent_state=agent.state, generator=g,
            env_steps=carry.env_steps + steps_per_iter * num_envs)
        return new_carry, metrics

    return init_fn, train_step_fn


@dataclasses.dataclass
class OnPolicyCarry:
    rollout: RolloutState
    agent_state: Any                # the agent's own state (agent.state)
    generator: torch.Generator      # on the envs' device
    env_steps: int                  # total env steps taken


def make_onpolicy_train_fns(env_cfg: EnvConfig, agent, num_envs: int,
                            n_steps: Optional[int] = None,
                            device=None) -> Tuple[Callable, Callable]:
    """Build (init_fn, train_step_fn) for an on-policy agent (PPO, A2C).

    init_fn(assets, seed) -> OnPolicyCarry
    train_step_fn(assets, carry) -> (carry, metrics)

    Each train step collects ``n_steps`` (default: the agent's) per env and
    then runs the agent's full update on the rollout. Per env step: the
    action, its log-prob and the value of the current stack; the env step
    with the pre-auto-reset observation; the value of the terminal stack,
    folded into the reward of envs that were truncated by the time limit
    (SB3's timeout bootstrap); then the stack moves on. The rows go into
    time-major tensors allocated once per train step (``obs`` is
    (T, E, S*C, H, W) uint8). ``mean_step_reward`` is the mean of the raw
    reward, before the bootstrap.

    ``device=None`` means the GPU; the assets must be on the same device.
    """
    dev = resolve_device(device)
    fs = env_cfg.frame_stack
    res = env_cfg.simulator.renderer.obs_res
    n_steps = n_steps or agent.cfg.n_steps

    def init_fn(assets: Assets, seed: int = 0) -> OnPolicyCarry:
        _check_device(assets, dev)
        generator, env_state, obs = _first_reset(env_cfg, assets, num_envs,
                                                 seed)
        agent_state = agent.init(seed=seed, obs_res=res, device=assets.device)
        return OnPolicyCarry(
            rollout=RolloutState(env_state, init_stack(obs, fs)),
            agent_state=agent_state, generator=generator, env_steps=0)

    def train_step_fn(assets: Assets, carry: OnPolicyCarry
                      ) -> Tuple[OnPolicyCarry, Dict[str, torch.Tensor]]:
        _check_device(assets, dev)
        _, step_fn = make_env_fns(env_cfg, assets, render=True,
                                  with_final_obs=True)
        g, rs = carry.generator, carry.rollout
        d = assets.device

        def rows(*shape, dtype=torch.float32):
            return torch.empty((n_steps, num_envs) + shape, dtype=dtype,
                               device=d)

        rollout = dict(obs=rows(*rs.obs_stack.shape[1:], dtype=torch.uint8),
                       action=rows(2), log_prob=rows(), value=rows(),
                       reward=rows(), done=rows(dtype=torch.bool),
                       raw_reward=rows())
        with torch.no_grad():
            for t in range(n_steps):
                a, logp, value = agent.select_action(rs.obs_stack, g)
                out = step_fn(rs.env_state, scale_action(a), g)
                done = out.terminated | out.truncated
                # terminal frame stack: final_obs shifted in WITHOUT the
                # episode-boundary refill (it belongs to the ending episode)
                c = out.final_obs.shape[1]
                final_stack = torch.cat([rs.obs_stack[:, c:], out.final_obs],
                                        dim=1)
                reward = bootstrap_truncated_rewards(
                    out.reward, out.terminated, out.truncated,
                    agent.value(final_stack), agent.cfg.gamma)
                for k, v in (("obs", rs.obs_stack), ("action", a),
                             ("log_prob", logp), ("value", value),
                             ("reward", reward), ("done", done),
                             ("raw_reward", out.reward)):
                    rollout[k][t] = v
                rs = RolloutState(out.state,
                                  update_stack(rs.obs_stack, out.obs, done))
            last_value = agent.value(rs.obs_stack)

        metrics = dict(agent.update(rollout, last_value, generator=g))
        metrics["mean_step_reward"] = rollout["raw_reward"].mean()
        new_carry = OnPolicyCarry(
            rollout=rs, agent_state=agent.state, generator=g,
            env_steps=carry.env_steps + n_steps * num_envs)
        return new_carry, metrics

    return init_fn, train_step_fn
