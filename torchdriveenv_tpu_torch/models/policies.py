"""Actor / critic heads over the NatureCNN torso (port of
``torchdriveenv_tpu/models/policies.py``).

  - SAC:  squashed-Gaussian actor + twin Q critic (``SquashedGaussianActor``,
          ``DoubleQCritic``)
  - TD3:  deterministic tanh actor + twin Q critic (``DeterministicActor``)
  - PPO/A2C: shared-torso Gaussian actor-critic with a state-independent
          log-std (``GaussianActorCritic``)

Actions live in the env's box [(-1, 1), (-0.3, 0.3)]; actors emit
tanh-squashed values in (-1, 1)^2 which are rescaled to the box here, so
learners work in normalized space. Only the torso runs in ``compute_dtype``;
the heads are f32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchdriveenv_tpu_torch.maps.arrays import device_constant
from torchdriveenv_tpu_torch.models.cnn import NatureCNN, flax_default_init_

# env action bounds [accel, steer]
ACTION_LOW = (-1.0, -0.3)
ACTION_HIGH = (1.0, 0.3)
LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def _bounds(like: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The action box as tensors on ``like``'s device."""
    return (device_constant(ACTION_LOW, like.device, like.dtype),
            device_constant(ACTION_HIGH, like.device, like.dtype))


def scale_action(tanh_a: torch.Tensor) -> torch.Tensor:
    """(-1, 1)^2 -> env action box. Clips to the box first: Gaussian
    policies (PPO/A2C) hand over raw samples. No-op clip for tanh-squashed
    (SAC/TD3) actions."""
    low, high = _bounds(tanh_a)
    a = torch.clamp(tanh_a, -1.0, 1.0)
    return low + (a + 1.0) * 0.5 * (high - low)


def unscale_action(a: torch.Tensor) -> torch.Tensor:
    """env action box -> (-1, 1)^2."""
    low, high = _bounds(a)
    return 2.0 * (a - low) / (high - low) - 1.0


class SquashedGaussianActor(nn.Module):
    """SAC actor: NatureCNN -> (mu, log_std); sample -> tanh -> scale."""

    def __init__(self, in_channels: int = 9, action_dim: int = 2,
                 features: int = 512, obs_res: int = 64,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.torso = NatureCNN(in_channels, features, obs_res, compute_dtype)
        self.latent = nn.Linear(features, 256)
        self.mu = nn.Linear(256, action_dim)
        self.log_std = nn.Linear(256, action_dim)
        flax_default_init_(self)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(self.latent(self.torso(obs)))
        log_std = torch.clamp(self.log_std(h), LOG_STD_MIN, LOG_STD_MAX)
        return self.mu(h), log_std


def sample_squashed(mu: torch.Tensor, log_std: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    noise: Optional[torch.Tensor] = None):
    """Reparameterized tanh-Gaussian sample with its log-prob.

    ``noise``: the standard-normal draw, shaped like ``mu``; drawn from
    ``generator`` (on ``mu``'s device) when absent."""
    if noise is None:
        noise = torch.randn(mu.shape, generator=generator, device=mu.device,
                            dtype=mu.dtype)
    std = torch.exp(log_std)
    pre_tanh = mu + std * noise
    a = torch.tanh(pre_tanh)
    log_prob = (-0.5 * noise ** 2 - log_std
                - 0.5 * math.log(2.0 * math.pi)).sum(-1)
    # tanh correction in its numerically stable softplus form
    log_prob = log_prob - (2.0 * (math.log(2.0) - pre_tanh
                                  - F.softplus(-2.0 * pre_tanh))).sum(-1)
    return a, log_prob


class DeterministicActor(nn.Module):
    """TD3 actor: NatureCNN -> tanh action."""

    def __init__(self, in_channels: int = 9, action_dim: int = 2,
                 features: int = 512, obs_res: int = 64,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.torso = NatureCNN(in_channels, features, obs_res, compute_dtype)
        self.latent = nn.Linear(features, 256)
        self.mu = nn.Linear(256, action_dim)
        flax_default_init_(self)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.mu(F.relu(self.latent(self.torso(obs)))))


class DoubleQCritic(nn.Module):
    """Twin Q networks over (obs, action) for SAC/TD3: two torsos, the
    action joined after each."""

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

    def forward(self, obs: torch.Tensor, action: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        qs = []
        for name in ("q1", "q2"):
            h = getattr(self, f"{name}_torso")(obs)
            h = torch.cat([h, action], dim=-1)
            h = F.relu(getattr(self, f"{name}_h")(h))
            qs.append(getattr(self, f"{name}_out")(h)[..., 0])
        return qs[0], qs[1]


class GaussianActorCritic(nn.Module):
    """PPO/A2C: shared NatureCNN torso, Gaussian policy head with a learned
    state-independent log-std, value head (orthogonal init 0.01 / 1.0)."""

    def __init__(self, in_channels: int = 9, action_dim: int = 2,
                 features: int = 512, obs_res: int = 64,
                 compute_dtype=torch.bfloat16):
        super().__init__()
        self.torso = NatureCNN(in_channels, features, obs_res, compute_dtype)
        self.mu = nn.Linear(features, action_dim)
        self.value = nn.Linear(features, 1)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        flax_default_init_(self)
        nn.init.orthogonal_(self.mu.weight, gain=0.01)
        nn.init.orthogonal_(self.value.weight, gain=1.0)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        h = self.torso(obs)
        mu = self.mu(h)
        return mu, self.log_std.expand_as(mu), self.value(h)[..., 0]


def gaussian_log_prob(mu, log_std, action):
    """Diagonal Gaussian log-prob of ``action`` (normalized space)."""
    z = (action - mu) / torch.exp(log_std)
    return (-0.5 * z ** 2 - log_std - 0.5 * math.log(2.0 * math.pi)).sum(-1)


def gaussian_entropy(log_std):
    return (log_std + 0.5 * math.log(2.0 * math.pi * math.e)).sum(-1)
