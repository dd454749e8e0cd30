"""SAC learner (port of ``torchdriveenv_tpu/rl/sac.py``).

SB3-default hyperparameters: lr 3e-4, gamma 0.99, tau 0.005, batch 256,
automatic entropy tuning with target entropy = -action_dim.

The agent holds its networks and optimizers (``SACState``) and updates them
in place. One ``update`` takes all three gradients (critic, actor,
temperature) at the parameters it started from, and only then applies the
three Adam steps and the polyak average, which uses the new critic: the
order of the JAX package, not SB3's critic-step-then-actor-loss.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from torchdriveenv_tpu_torch.maps.arrays import resolve_device
from torchdriveenv_tpu_torch.models.policies import (
    DoubleQCritic,
    SquashedGaussianActor,
    sample_squashed,
)
from torchdriveenv_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    mean_over,
)
from torchdriveenv_tpu_torch.rl.optim import adam_export, adam_load, apply_grads


@dataclasses.dataclass
class SACConfig:
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    # SB3's default is 1e6 transitions; 1e5 keeps the single frames
    # (E*N, 3, 64, 64) beside the envs and the learner on one device
    buffer_size: int = 100_000
    learning_starts: int = 100      # SB3 default
    target_entropy: float = -2.0    # -action_dim (SB3 "auto")
    init_alpha: float = 1.0
    # critic warmup for warm-started actors: actor and temperature updates
    # are applied only from this gradient step on. 0 = SB3 behavior.
    actor_delay_updates: int = 0
    # fixed entropy temperature (SB3's ent_coef=<float> mode): disables
    # auto-tuning. None = SB3 "auto".
    fixed_alpha: Optional[float] = None
    # demonstration regularization: adds
    # bc_coef * is_demo * ||tanh(mu) - a_demo||^2 to the actor loss
    bc_coef: float = 0.0


def alpha_loss_sb3(log_alpha: torch.Tensor, logp_mean: torch.Tensor,
                   target_entropy: float) -> torch.Tensor:
    """SB3's temperature loss: -(log_alpha * (logp + target_entropy)). The
    gradient lands on log_alpha itself, not scaled by exp(log_alpha)."""
    return -(log_alpha * (logp_mean + target_entropy))


@dataclasses.dataclass
class SACState:
    actor: SquashedGaussianActor
    critic: DoubleQCritic
    target_critic: DoubleQCritic
    log_alpha: torch.Tensor         # () leaf tensor
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    alpha_opt: torch.optim.Adam
    step: int = 0                   # gradient updates taken


class SAC:
    """Holds the config and, after ``init`` or ``load_state``, the agent's
    state (``self.state``)."""

    # what ``update`` reports (a train step reports zeros while it warms up)
    metric_names = ("critic_loss", "actor_loss", "alpha_loss", "alpha", "q1",
                    "q2", "entropy")

    def __init__(self, cfg: SACConfig = SACConfig(), obs_channels: int = 9,
                 compute_dtype=torch.bfloat16):
        self.cfg = cfg
        self.obs_channels = obs_channels
        self.compute_dtype = compute_dtype
        self.state: Optional[SACState] = None

    # -- state ------------------------------------------------------------

    def init(self, seed: int = 0, obs_res: int = 64, device=None) -> SACState:
        """Fresh networks (initialised from ``seed``), a target critic equal
        to the critic, and three Adam optimizers, on ``device`` (default:
        the GPU)."""
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            actor = SquashedGaussianActor(self.obs_channels, obs_res=obs_res,
                                          compute_dtype=self.compute_dtype)
            critic = DoubleQCritic(self.obs_channels, obs_res=obs_res,
                                   compute_dtype=self.compute_dtype)
        actor, critic = actor.to(dev), critic.to(dev)
        target = copy.deepcopy(critic).requires_grad_(False)
        log_alpha = torch.tensor(math.log(self.cfg.init_alpha),
                                 dtype=torch.float32, device=dev,
                                 requires_grad=True)
        lr = self.cfg.lr
        self.state = SACState(
            actor=actor, critic=critic, target_critic=target,
            log_alpha=log_alpha,
            actor_opt=torch.optim.Adam(actor.parameters(), lr=lr),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=lr),
            alpha_opt=torch.optim.Adam([log_alpha], lr=lr),
            step=0)
        return self.state

    def _named(self):
        st = self.state
        return (list(st.actor.named_parameters()),
                list(st.critic.named_parameters()), [("", st.log_alpha)])

    def load_state(self, converted: Mapping[str, Any]) -> SACState:
        """Take over a whole agent state as ``convert.sac_state_to_torch``
        returns it (parameters, targets, temperature, step count and the
        three Adam states). Call ``init`` first: it fixes the device."""
        st = self.state
        st.actor.load_state_dict(converted["actor"])
        st.critic.load_state_dict(converted["critic"])
        st.target_critic.load_state_dict(converted["target_critic"])
        with torch.no_grad():
            st.log_alpha.copy_(converted["log_alpha"])
        st.step = int(converted["step"])
        for opt, named, key in zip(
                (st.actor_opt, st.critic_opt, st.alpha_opt), self._named(),
                ("actor_opt", "critic_opt", "alpha_opt")):
            adam_load(opt, named, converted[key])
        return st

    def export_state(self) -> Dict[str, Any]:
        """The inverse of ``load_state`` (detached copies)."""
        st = self.state
        out: Dict[str, Any] = {
            k: {n: v.detach().clone() for n, v in m.state_dict().items()}
            for k, m in (("actor", st.actor), ("critic", st.critic),
                         ("target_critic", st.target_critic))}
        out["log_alpha"] = st.log_alpha.detach().clone()
        out["step"] = st.step
        for opt, named, key in zip(
                (st.actor_opt, st.critic_opt, st.alpha_opt), self._named(),
                ("actor_opt", "critic_opt", "alpha_opt")):
            out[key] = adam_export(opt, named)
        return out

    # -- acting -----------------------------------------------------------

    @torch.no_grad()
    def select_action(self, obs: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = False,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Normalized (-1, 1) action; the caller rescales to the env box."""
        mu, log_std = self.state.actor(obs)
        if deterministic:
            return torch.tanh(mu)
        return sample_squashed(mu, log_std, generator, noise)[0]

    # -- learning ---------------------------------------------------------

    def update(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """One gradient update on ``batch`` (as ``buffer.sample`` returns
        it), in place. ``noise=(n_next, n_pi)``: the standard-normal draws
        of the two ``sample_squashed`` calls, each (B, A) over the global
        batch; drawn from ``generator`` in that order when absent, and
        indexed by ``batch["pos"]``, the rows' places in the global batch
        (``arange(B)`` in one process). Returns the seven metrics as 0-d
        tensors on the agent's device.

        With a ``mesh`` the batch holds this rank's rows of a global batch
        of ``batch_size``: the losses are this rank's sums over the global
        size, and the gradients, the mean log-prob and the metrics are
        summed over the ranks."""
        cfg, st = self.cfg, self.state
        b = batch["reward"].shape[0] if mesh is None else cfg.batch_size
        if noise is None:
            shape = (b,) + batch["action"].shape[1:]
            noise = [torch.randn(shape, generator=generator,
                                 device=batch["action"].device)
                     for _ in range(2)]
        n_next, n_pi = (x[batch["pos"]] for x in noise)
        fixed = cfg.fixed_alpha is not None
        # torch.full fills on the device; torch.tensor would upload, which
        # synchronizes the host with the device at every update
        alpha = (torch.full((), cfg.fixed_alpha, dtype=torch.float32,
                            device=st.log_alpha.device)
                 if fixed else torch.exp(st.log_alpha.detach()))
        obs, next_obs = batch["obs"], batch["next_obs"]
        critic_params = list(st.critic.parameters())
        actor_params = list(st.actor.parameters())

        # critic target: the current actor and the target critic
        with torch.no_grad():
            mu_n, ls_n = st.actor(next_obs)
            next_a, next_logp = sample_squashed(mu_n, ls_n, generator, n_next)
            tq1, tq2 = st.target_critic(next_obs, next_a)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = (batch["reward"]
                        + cfg.gamma * batch["discount_mask"] * target_v)

        q1, q2 = st.critic(obs, batch["action"])
        critic_loss = mean_over((q1 - target_q) ** 2 + (q2 - target_q) ** 2,
                                b, mesh)
        critic_grads = torch.autograd.grad(critic_loss, critic_params)

        # actor loss through the critic as it was before this update; the
        # gradient is taken for the actor's parameters only
        mu, log_std = st.actor(obs)
        a, logp = sample_squashed(mu, log_std, generator, n_pi)
        q1_pi, q2_pi = st.critic(obs, a)
        actor_loss = mean_over(alpha * logp - torch.minimum(q1_pi, q2_pi),
                               b, mesh)
        if cfg.bc_coef:
            demo = batch["is_demo"].to(torch.float32)
            # targets clipped inside the open interval: the scripted driver
            # saturates accel at exactly +-1, and mse(tanh(mu), +-1) drives
            # mu to infinity
            tgt = torch.clamp(batch["action"], -0.98, 0.98)
            bc = mean_over(demo * ((torch.tanh(mu) - tgt) ** 2).sum(-1), b,
                           mesh)
            actor_loss = actor_loss + cfg.bc_coef * bc
        actor_grads = torch.autograd.grad(actor_loss, actor_params)
        logp_mean = mean_over(logp.detach(), b, mesh)
        q_means = [mean_over(q1.detach(), b, mesh),
                   mean_over(q2.detach(), b, mesh)]
        critic_loss, actor_loss = critic_loss.detach(), actor_loss.detach()
        if mesh is not None:    # one collective for all of it
            sums = torch.stack([logp_mean, critic_loss, actor_loss] + q_means)
            all_reduce_(list(critic_grads) + list(actor_grads) + [sums], mesh)
            logp_mean, critic_loss, actor_loss, *q_means = sums.unbind(0)

        alpha_loss = alpha_loss_sb3(st.log_alpha, logp_mean,
                                    cfg.target_entropy)
        (alpha_grad,) = torch.autograd.grad(alpha_loss, [st.log_alpha])

        # every gradient is in hand: now the Adam steps
        apply_grads(st.critic_opt, critic_params, critic_grads)
        with torch.no_grad():       # polyak average towards the new critic
            targets = list(st.target_critic.parameters())
            torch._foreach_mul_(targets, 1.0 - cfg.tau)
            torch._foreach_add_(targets, critic_params, alpha=cfg.tau)

        # while the actor is delayed, the actor, the temperature and both
        # their optimizers (step counts included) stay as they were
        if st.step >= cfg.actor_delay_updates:
            apply_grads(st.actor_opt, actor_params, actor_grads)
            # a fixed temperature: Adam's moments advance, log_alpha does not
            kept = st.log_alpha.detach().clone() if fixed else None
            apply_grads(st.alpha_opt, [st.log_alpha], [alpha_grad])
            if fixed:
                with torch.no_grad():
                    st.log_alpha.copy_(kept)
        st.step += 1

        return dict(critic_loss=critic_loss, actor_loss=actor_loss,
                    alpha_loss=alpha_loss.detach(), alpha=alpha,
                    q1=q_means[0], q2=q_means[1], entropy=-logp_mean)
