"""The benchmark's reference for the on-policy update of PPO: the
Gaussian actor-critic over the NatureCNN torso, GAE and the clipped
surrogate over a time-major rollout, in one process over the global batch.

Written from arXiv:1707.06347 and Stable-Baselines3's ``PPO.train``, not
from the port; it imports nothing of the port or of JAX. What comes in:
the weights and Adam state before the update, the rollout's frame stacks
and actions, each env step's raw reward, termination and truncation, the
terminal frame stacks of the truncated envs, the last frame stack, and the
generator state the permutations are drawn from.

``rollout``: the value and the log-prob of every row under the weights
before the update, the truncated envs' bootstrap (``gamma * V(terminal
stack)`` added to the reward where an env was truncated and not
terminated), the last value; ``gae``: advantages and returns from them.

``update``: ``n_epochs`` permutations of the T * N flattened rows, each
walked in minibatches of ``batch_size``. Per minibatch: the advantages
normalised over the minibatch, the clipped surrogate, the squared error of
the value, the entropy, their sum ``pg + vf_coef * v - ent_coef * ent``;
its gradient clipped by the global norm, one Adam step. With ``forced``
(the weights before each gradient step, as another learner took them) each
step starts from the given weights, keeping its own Adam moments: every
step's loss, gradient and change is then the reference's at the same point
as the other learner's, so rounding does not compound over the update.

Departures from SB3 and the paper, as the configuration runs PPO:

- the advantages are normalised with the population standard deviation
  (SB3: the sample one), ``(a - mean) / (std + 1e-8)``;
- the clip by the global norm is optax's (``g * max_norm / norm`` where
  the norm exceeds ``max_norm``; SB3: ``max_norm / (norm + 1e-6)``);
- the log-std is one learned vector (state-independent), and the
  minibatch remainder of a permutation is dropped (SB3 keeps a short last
  minibatch; the configuration's rollout has none);
- the torso runs in bfloat16 under autocast, the heads and Adam in
  float32; no value clipping (SB3's default).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch
from torch import nn

from .cnn import NatureCNN


@dataclasses.dataclass
class PPOConfig:
    lr: float = 3e-4
    n_steps: int = 2048
    batch_size: int = 256
    n_epochs: int = 5
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5


ADAM_EPS = 1e-5


class GaussianActorCritic(nn.Module):
    """A shared torso, a Gaussian mean head, a value head and one learned
    log-std vector; parameter names as the port's state dict has them."""

    def __init__(self, in_channels: int = 9, action_dim: int = 2,
                 features: int = 512, obs_res: int = 64,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.torso = NatureCNN(in_channels, features, obs_res, compute_dtype)
        self.mu = nn.Linear(features, action_dim)
        self.value = nn.Linear(features, 1)
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs):
        h = self.torso(obs)
        mu = self.mu(h)
        return mu, self.log_std.expand_as(mu), self.value(h)[..., 0]


def log_prob(mu, log_std, action):
    """Diagonal Gaussian log-density of ``action``."""
    z = (action - mu) / torch.exp(log_std)
    return (-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi)).sum(-1)


def entropy(log_std):
    return (log_std + 0.5 * math.log(2.0 * math.pi * math.e)).sum(-1)


@torch.no_grad()
def gae(reward, value, done, last_value, gamma: float, lam: float):
    """(advantages, returns), each (T, N), of a time-major rollout; an
    episode that ends at step t takes no value or advantage from t + 1."""
    steps = reward.shape[0]
    advantages = torch.zeros_like(reward)
    running = torch.zeros_like(last_value)
    for t in reversed(range(steps)):
        live = 1.0 - done[t].float()
        next_value = last_value if t == steps - 1 else value[t + 1]
        delta = reward[t] + gamma * next_value * live - value[t]
        running = delta + gamma * lam * live * running
        advantages[t] = running
    return advantages, advantages + value


def clip_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """In place: every gradient times ``max_norm / norm`` where the global
    norm exceeds ``max_norm``."""
    norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).float()
    scale = torch.where(norm > max_norm, max_norm / norm,
                        torch.ones_like(norm))
    for g in grads:
        g.mul_(scale)


def network(weights: Dict[str, torch.Tensor], device, obs_channels: int = 9,
            obs_res: int = 64, compute_dtype=torch.bfloat16
            ) -> GaussianActorCritic:
    net = GaussianActorCritic(obs_channels, obs_res=obs_res,
                              compute_dtype=compute_dtype)
    net.load_state_dict(weights)
    return net.to(device)


@torch.no_grad()
def _values(net, obs: torch.Tensor, action: Optional[torch.Tensor] = None,
            chunk: int = 4096):
    """The value (and the log-prob of ``action``) of every row of ``obs``
    (R, C, H, W), in chunks."""
    values, logps = [], []
    for lo in range(0, obs.shape[0], chunk):
        mu, log_std, value = net(obs[lo:lo + chunk])
        values.append(value)
        if action is not None:
            logps.append(log_prob(mu, log_std, action[lo:lo + chunk]))
    value = torch.cat(values) if values else obs.new_zeros(0, dtype=torch.float32)
    return value, (torch.cat(logps) if action is not None else None)


@torch.no_grad()
def rollout(cfg: PPOConfig, net, obs, action, raw_reward, terminated,
            truncated, final_at, final_obs, last_obs) -> Dict:
    """The rollout's numbers under ``net``: ``value`` and ``log_prob``
    (T, N) of the frame stacks ``obs`` (T, N, C, H, W) and ``action`` (T,
    N, 2); ``reward`` (T, N), the raw reward plus ``gamma * V(terminal
    stack)`` where an env was truncated and not terminated (``final_obs``
    holds the terminal stacks of the rows ``final_at`` (R, 2) = (t, env),
    every truncated row among them); ``last_value`` (N,) of ``last_obs``."""
    steps, envs = raw_reward.shape
    flat = obs.reshape((steps * envs,) + tuple(obs.shape[2:]))
    value, logp = _values(net, flat, action.reshape(steps * envs, -1))
    v_final = torch.zeros_like(raw_reward)
    v_final[final_at[:, 0], final_at[:, 1]] = _values(net, final_obs)[0]
    boot = truncated & ~terminated
    reward = raw_reward + cfg.gamma * torch.where(
        boot, v_final, torch.zeros_like(v_final))
    return {"value": value.reshape(steps, envs),
            "log_prob": logp.reshape(steps, envs), "reward": reward,
            "last_value": _values(net, last_obs)[0]}


def _adam(cfg: PPOConfig, named, state: Optional[Dict]):
    """Adam over ``named`` parameters, its moments and step count taken
    from ``state`` ({"step", "exp_avg", "exp_avg_sq"} by name) if given."""
    opt = torch.optim.Adam([p for _, p in named], lr=cfg.lr, eps=ADAM_EPS)
    if state and state["step"]:
        for n, p in named:
            opt.state[p] = {
                "step": torch.tensor(float(state["step"])),
                "exp_avg": state["exp_avg"][n].to(p.device).clone(),
                "exp_avg_sq": state["exp_avg_sq"][n].to(p.device).clone()}
    return opt


def update(cfg: PPOConfig, net, adam_state: Optional[Dict],
           obs, action, old_log_prob, advantages, returns,
           perm_generator_state: torch.Tensor, device,
           forced: Optional[List[Dict[str, torch.Tensor]]] = None,
           row_order: Optional[torch.Generator] = None) -> Dict:
    """One PPO update of ``net`` (in place) on a global time-major rollout
    (obs (T, N, C, H, W) uint8, action (T, N, 2), old_log_prob,
    advantages, returns (T, N)), Adam from ``adam_state`` (fresh if None),
    the permutations drawn with ``torch.randperm`` from a generator on
    ``device`` set to ``perm_generator_state``.

    ``forced``: the weights before each gradient step, by name; each step
    starts there. ``row_order``: each minibatch's rows taken in an order
    drawn from it (the same rows: only the order of the sums moves).

    -> {"losses": (steps, 4) tensor of each minibatch's (loss, pg, v,
    ent), "grads": each step's clipped gradient by name, "changes": each
    step's change of the weights by name}."""
    named = list(net.named_parameters())
    params = [p for _, p in named]
    opt = _adam(cfg, named, adam_state)
    steps, envs = advantages.shape
    rows = steps * envs
    obs = obs.reshape((rows,) + tuple(obs.shape[2:]))
    action = action.reshape(rows, -1)
    old_logp = old_log_prob.reshape(rows)
    adv_flat, ret_flat = advantages.reshape(rows), returns.reshape(rows)
    g = torch.Generator(device=device)
    g.set_state(perm_generator_state)
    perms = [torch.randperm(rows, generator=g, device=device)
             for _ in range(cfg.n_epochs)]

    losses, grads_out, changes = [], [], []
    m = cfg.batch_size
    for perm in perms:
        for lo in range(0, rows - m + 1, m):
            idx = perm[lo:lo + m]
            if row_order is not None:
                idx = idx[torch.randperm(m, generator=row_order).to(device)]
            if forced is not None:
                with torch.no_grad():
                    for n, p in named:
                        p.copy_(forced[len(losses)][n])
            start = [p.detach().clone() for p in params]
            mu, log_std, value = net(obs[idx])
            ratio = torch.exp(log_prob(mu, log_std, action[idx])
                              - old_logp[idx])
            adv = adv_flat[idx]
            adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
            surrogate = torch.minimum(
                ratio * adv,
                torch.clamp(ratio, 1 - cfg.clip_range, 1 + cfg.clip_range)
                * adv)
            pg_loss = -surrogate.mean()
            v_loss = ((value - ret_flat[idx]) ** 2).mean()
            ent = entropy(log_std).mean()
            loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
            grads = list(torch.autograd.grad(loss, params))
            clip_global_norm(grads, cfg.max_grad_norm)
            for p, gr in zip(params, grads):
                p.grad = gr
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append(torch.stack([loss, pg_loss, v_loss, ent]).detach())
            grads_out.append({n: gr for (n, _), gr in zip(named, grads)})
            changes.append({n: p.detach() - s
                            for (n, p), s in zip(named, start)})
    return {"losses": torch.stack(losses), "grads": grads_out,
            "changes": changes}
