"""The benchmark's reference for the off-policy train step of SAC: the
squashed-Gaussian actor and the twin-Q critic over the NatureCNN torso,
the SAC update and the train step (env steps into the replay ring, then
updates on sampled batches), in one process.

A frozen copy of the port's ``models/policies.py`` (the SAC heads),
``rl/sac.py`` (``update``), ``rl/rollout.py`` (the frame stack) and
``parallel/train_step.py`` (the off-policy step), which later changes to
the port do not reach. The optimizer is ``torch.optim.Adam``, as in the
port. What the benchmark hands both sides (the weights, the env's first
state's generator) comes in; everything else is worked out here again.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from . import buffer as replay
from . import env as renv
from .arrays import device_constant
from .cnn import NatureCNN, flax_default_init_

ACTION_LOW = (-1.0, -0.3)
ACTION_HIGH = (1.0, 0.3)
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def _bounds(like):
    return (device_constant(ACTION_LOW, like.device, like.dtype),
            device_constant(ACTION_HIGH, like.device, like.dtype))


def scale_action(tanh_a: torch.Tensor) -> torch.Tensor:
    """(-1, 1)^2 -> env action box, clipped to the box first."""
    low, high = _bounds(tanh_a)
    a = torch.clamp(tanh_a, -1.0, 1.0)
    return low + (a + 1.0) * 0.5 * (high - low)


def unscale_action(a: torch.Tensor) -> torch.Tensor:
    """env action box -> (-1, 1)^2."""
    low, high = _bounds(a)
    return 2.0 * (a - low) / (high - low) - 1.0


class SquashedGaussianActor(nn.Module):
    def __init__(self, in_channels: int = 9, action_dim: int = 2,
                 features: int = 512, obs_res: int = 64,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.torso = NatureCNN(in_channels, features, obs_res, compute_dtype)
        self.latent = nn.Linear(features, 256)
        self.mu = nn.Linear(256, action_dim)
        self.log_std = nn.Linear(256, action_dim)
        flax_default_init_(self)

    def forward(self, obs):
        h = F.relu(self.latent(self.torso(obs)))
        log_std = torch.clamp(self.log_std(h), LOG_STD_MIN, LOG_STD_MAX)
        return self.mu(h), log_std


def sample_squashed(mu, log_std, generator=None, noise=None):
    """Reparameterized tanh-Gaussian sample with its log-prob."""
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                            dtype=mu.dtype)
    std = torch.exp(log_std)
    pre_tanh = mu + std * noise
    a = torch.tanh(pre_tanh)
    log_prob = (-0.5 * noise ** 2 - log_std
                - 0.5 * math.log(2.0 * math.pi)).sum(-1)
    log_prob = log_prob - (2.0 * (math.log(2.0) - pre_tanh
                                  - F.softplus(-2.0 * pre_tanh))).sum(-1)
    return a, log_prob


class DoubleQCritic(nn.Module):
    def __init__(self, in_channels: int = 9, action_dim: int = 2,
                 features: int = 512, obs_res: int = 64,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        for name in ("q1", "q2"):
            setattr(self, f"{name}_torso",
                    NatureCNN(in_channels, features, obs_res, compute_dtype))
            setattr(self, f"{name}_h", nn.Linear(features + action_dim, 256))
            setattr(self, f"{name}_out", nn.Linear(256, 1))
        flax_default_init_(self)

    def forward(self, obs, action):
        qs = []
        for name in ("q1", "q2"):
            h = getattr(self, f"{name}_torso")(obs)
            h = torch.cat([h, action], dim=-1)
            h = F.relu(getattr(self, f"{name}_h")(h))
            qs.append(getattr(self, f"{name}_out")(h)[..., 0])
        return qs[0], qs[1]


@dataclasses.dataclass
class SACConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    buffer_size: int = 100_000
    learning_starts: int = 100
    target_entropy: float = -2.0
    init_alpha: float = 1.0
    actor_delay_updates: int = 0
    fixed_alpha: Optional[float] = None
    bc_coef: float = 0.0


class SAC:
    """Networks, optimizers and the update, built from given weights."""

    def __init__(self, cfg: SACConfig, actor_sd: Dict, critic_sd: Dict,
                 device, obs_channels: int = 9, obs_res: int = 64,
                 compute_dtype=torch.bfloat16):
        self.cfg = cfg
        self.actor = SquashedGaussianActor(obs_channels, obs_res=obs_res,
                                           compute_dtype=compute_dtype)
        self.critic = DoubleQCritic(obs_channels, obs_res=obs_res,
                                    compute_dtype=compute_dtype)
        self.target = DoubleQCritic(obs_channels, obs_res=obs_res,
                                    compute_dtype=compute_dtype)
        self.actor.load_state_dict(actor_sd)
        self.critic.load_state_dict(critic_sd)
        self.target.load_state_dict(critic_sd)
        for m in (self.actor, self.critic, self.target):
            m.to(device)
        self.target.requires_grad_(False)
        self.log_alpha = torch.tensor(math.log(cfg.init_alpha),
                                      dtype=torch.float32, device=device,
                                      requires_grad=True)
        self.actor_opt = torch.optim.Adam(self.actor.parameters(), lr=cfg.lr)
        self.critic_opt = torch.optim.Adam(self.critic.parameters(),
                                           lr=cfg.lr)
        self.alpha_opt = torch.optim.Adam([self.log_alpha], lr=cfg.lr)
        self.step = 0
        # the first update's critic gradients, by parameter name
        self.first_critic_grads: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def select_action(self, obs, generator, noise):
        mu, log_std = self.actor(obs)
        return sample_squashed(mu, log_std, generator, noise)[0]

    @staticmethod
    def _apply(opt, params, grads):
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        opt.zero_grad(set_to_none=True)

    def update(self, batch, generator) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        b = batch["reward"].shape[0]
        shape = (b,) + batch["action"].shape[1:]
        noise = [torch.randn(shape, generator=generator,
                             device=batch["action"].device) for _ in range(2)]
        n_next, n_pi = (x[batch["pos"]] for x in noise)
        fixed = cfg.fixed_alpha is not None
        alpha = (torch.full((), cfg.fixed_alpha, dtype=torch.float32,
                            device=self.log_alpha.device)
                 if fixed else torch.exp(self.log_alpha.detach()))
        obs, next_obs = batch["obs"], batch["next_obs"]
        critic_named = list(self.critic.named_parameters())
        critic_params = [p for _, p in critic_named]
        actor_params = list(self.actor.parameters())

        with torch.no_grad():
            mu_n, ls_n = self.actor(next_obs)
            next_a, next_logp = sample_squashed(mu_n, ls_n, generator, n_next)
            tq1, tq2 = self.target(next_obs, next_a)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = (batch["reward"]
                        + cfg.gamma * batch["discount_mask"] * target_v)
        q1, q2 = self.critic(obs, batch["action"])
        critic_loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
        critic_grads = torch.autograd.grad(critic_loss, critic_params)

        mu, log_std = self.actor(obs)
        a, logp = sample_squashed(mu, log_std, generator, n_pi)
        q1_pi, q2_pi = self.critic(obs, a)
        actor_loss = (alpha * logp - torch.minimum(q1_pi, q2_pi)).mean()
        if cfg.bc_coef:
            demo = batch["is_demo"].to(torch.float32)
            tgt = torch.clamp(batch["action"], -0.98, 0.98)
            bc = (demo * ((torch.tanh(mu) - tgt) ** 2).sum(-1)).mean()
            actor_loss = actor_loss + cfg.bc_coef * bc
        actor_grads = torch.autograd.grad(actor_loss, actor_params)
        logp_mean = logp.detach().mean()
        alpha_loss = -(self.log_alpha * (logp_mean + cfg.target_entropy))
        (alpha_grad,) = torch.autograd.grad(alpha_loss, [self.log_alpha])

        if self.first_critic_grads is None:
            self.first_critic_grads = {n: g.detach().clone() for (n, _), g
                                       in zip(critic_named, critic_grads)}
        self._apply(self.critic_opt, critic_params, critic_grads)
        with torch.no_grad():
            targets = list(self.target.parameters())
            torch._foreach_mul_(targets, 1.0 - cfg.tau)
            torch._foreach_add_(targets, critic_params, alpha=cfg.tau)
        if self.step >= cfg.actor_delay_updates:
            self._apply(self.actor_opt, actor_params, actor_grads)
            kept = self.log_alpha.detach().clone() if fixed else None
            self._apply(self.alpha_opt, [self.log_alpha], [alpha_grad])
            if fixed:
                with torch.no_grad():
                    self.log_alpha.copy_(kept)
        self.step += 1
        return dict(critic_loss=critic_loss.detach(),
                    actor_loss=actor_loss.detach(),
                    q1=q1.detach().mean(), q2=q2.detach().mean(),
                    entropy=-logp_mean)


def init_stack(obs, frame_stack: int):
    return obs.repeat(1, frame_stack, 1, 1)


def update_stack(stack, new_frame, done):
    c = new_frame.shape[1]
    shifted = torch.cat([stack[:, c:], new_frame], dim=1)
    refilled = new_frame.repeat(1, stack.shape[1] // c, 1, 1)
    return torch.where(done[:, None, None, None], refilled, shifted)


@dataclasses.dataclass
class Carry:
    env_state: object
    obs_stack: torch.Tensor
    buffer: replay.ReplayBuffer
    generator: torch.Generator
    env_steps: int


def train_step(env_cfg, assets, agent: SAC, carry: Carry, num_envs: int,
               steps_per_iter: int, updates_per_iter: int,
               demo_fn: Optional[Callable], demo_steps: int,
               demo_envs: int, npc_params=None) -> Tuple[Carry, Dict]:
    """One off-policy train step: ``steps_per_iter`` env steps into the
    ring, then ``updates_per_iter`` updates (none while warming up)."""
    g, d = carry.generator, carry.obs_stack.device
    fs = env_cfg.frame_stack
    warmup = carry.env_steps < agent.cfg.learning_starts
    demo_mask = None
    if demo_fn is not None:
        demo_phase = carry.env_steps < demo_steps
        demo_mask = (torch.arange(num_envs, device=d)
                     < (num_envs if demo_phase else demo_envs))
    state, stack, buf = carry.env_state, carry.obs_stack, carry.buffer
    rewards = []
    for _ in range(steps_per_iter):
        with torch.no_grad():
            if warmup:
                a = torch.rand((num_envs, 2), generator=g, device=d) * 2 - 1
            else:
                noise = torch.randn((num_envs, 2), generator=g, device=d)
                a = agent.select_action(stack, g, noise)
            if demo_fn is not None:
                a_demo = torch.clamp(unscale_action(demo_fn(state)), -1, 1)
                a = torch.where(demo_mask[:, None], a_demo, a)
            out = renv.step(env_cfg, assets, state, scale_action(a), g,
                            npc_params, with_final_obs=True)
            done = out["terminated"] | out["truncated"]
            buf = replay.add(buf, stack[:, -3:], a, out["reward"], done,
                             out["terminated"], out["final_obs"],
                             demo_mask=demo_mask)
            stack = update_stack(stack, out["obs"], done)
            state = out["state"]
        rewards.append(out["reward"])
    if warmup:
        metrics = {}
    else:
        rows = [agent.update(replay.sample(buf, agent.cfg.batch_size, fs,
                                           generator=g), g)
                for _ in range(updates_per_iter)]
        metrics = {k: torch.stack([r[k] for r in rows]).mean()
                   for k in rows[0]}
    metrics["mean_step_reward"] = torch.stack(rewards).mean()
    return Carry(state, stack, buf, g,
                 carry.env_steps + steps_per_iter * num_envs), metrics
