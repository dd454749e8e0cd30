"""A2C learner (port of ``torchdriveenv_tpu/rl/a2c.py``).

SB3's A2C baseline of the reference (Adam in place of SB3's RMSprop,
``n_steps=256 // n_envs, gae_lambda=0.95, ent_coef=0.01``) with SB3 defaults
otherwise: lr 7e-4, gamma 0.99, vf_coef 0.5, max_grad_norm 0.5, no advantage
normalization, one pass over the whole rollout (no minibatches, no
clipping of the ratio).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from torchdriveenv_tpu_torch.models.policies import (
    GaussianActorCritic,
    gaussian_entropy,
    gaussian_log_prob,
)
from torchdriveenv_tpu_torch.rl.ppo import ActorCriticAgent, compute_gae


@dataclasses.dataclass
class A2CConfig:
    lr: float = 7e-4
    n_steps: int = 26             # reference: 256 // n_envs with n_envs=10
    gamma: float = 0.99
    gae_lambda: float = 0.95
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5


@dataclasses.dataclass
class A2CState:
    net: GaussianActorCritic
    opt: torch.optim.Adam
    step: int = 0                   # updates taken


class A2C(ActorCriticAgent):
    """Holds the config and, after ``init`` or ``load_state``, the agent's
    state (``self.state``). Acts like PPO: raw (unclipped) samples."""

    config_cls = A2CConfig
    state_cls = A2CState

    def update(self, rollout: Dict[str, torch.Tensor],
               last_value: torch.Tensor,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
        """One gradient step on the whole time-major rollout, in place.
        Nothing is drawn: ``generator`` is part of the learners' common
        signature only. Advantages and returns are constants of the loss."""
        del generator
        cfg, st = self.cfg, self.state
        with torch.no_grad():
            advs, returns = compute_gae(rollout["reward"], rollout["value"],
                                        rollout["done"], last_value,
                                        cfg.gamma, cfg.gae_lambda)
        n = advs.numel()
        obs = rollout["obs"].reshape((n,) + rollout["obs"].shape[2:])
        mu, log_std, value = st.net(obs)
        logp = gaussian_log_prob(mu, log_std, rollout["action"].reshape(n, -1))
        pg_loss = -(advs.reshape(n) * logp).mean()
        v_loss = ((value - returns.reshape(n)) ** 2).mean()
        ent = gaussian_entropy(log_std).mean()
        loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
        self._step(loss)
        st.step += 1
        return dict(loss=loss.detach(), pg_loss=pg_loss.detach(),
                    v_loss=v_loss.detach(), entropy=ent.detach())
