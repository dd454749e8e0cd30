"""TD3 learner (port of ``torchdriveenv_tpu/rl/td3.py``).

SB3's TD3 baseline of the reference (``train_freq=1, buffer_size=100000``)
with SB3 defaults: lr 1e-3, gamma 0.99, tau 0.005, batch 256, policy delay 2,
target policy noise 0.2 clipped at 0.5, exploration noise 0.1.

The agent holds its networks and optimizers (``TD3State``) and updates them
in place, behind the interface ``SAC`` has, so the off-policy train step
drives either. Unlike SAC's update, the critic takes its Adam step first and
the actor's loss goes through the new critic.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch

from torchdriveenv_tpu_torch.maps.arrays import resolve_device
from torchdriveenv_tpu_torch.models.policies import DeterministicActor, DoubleQCritic
from torchdriveenv_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    mean_over,
)
from torchdriveenv_tpu_torch.rl.optim import adam_export, adam_load, apply_grads


@dataclasses.dataclass
class TD3Config:
    lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    buffer_size: int = 100_000
    learning_starts: int = 100
    policy_delay: int = 2
    target_noise: float = 0.2
    noise_clip: float = 0.5
    explore_noise: float = 0.1


@dataclasses.dataclass
class TD3State:
    actor: DeterministicActor
    target_actor: DeterministicActor
    critic: DoubleQCritic
    target_critic: DoubleQCritic
    actor_opt: torch.optim.Adam
    critic_opt: torch.optim.Adam
    step: int = 0                   # gradient updates taken


def _polyak_(targets, sources, tau: float) -> None:
    torch._foreach_mul_(targets, 1.0 - tau)
    torch._foreach_add_(targets, sources, alpha=tau)


class TD3:
    """Holds the config and, after ``init`` or ``load_state``, the agent's
    state (``self.state``)."""

    # what ``update`` reports (a train step reports zeros while it warms up)
    metric_names = ("critic_loss", "actor_loss", "q1")
    _NETS = ("actor", "target_actor", "critic", "target_critic")

    def __init__(self, cfg: TD3Config = TD3Config(), obs_channels: int = 9,
                 compute_dtype=torch.bfloat16):
        self.cfg = cfg
        self.obs_channels = obs_channels
        self.compute_dtype = compute_dtype
        self.state: Optional[TD3State] = None

    # -- state ------------------------------------------------------------

    def init(self, seed: int = 0, obs_res: int = 64, device=None) -> TD3State:
        """Fresh networks (initialised from ``seed``), targets equal to
        them, and two Adam optimizers, on ``device`` (default: the GPU)."""
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            actor = DeterministicActor(self.obs_channels, obs_res=obs_res,
                                       compute_dtype=self.compute_dtype)
            critic = DoubleQCritic(self.obs_channels, obs_res=obs_res,
                                   compute_dtype=self.compute_dtype)
        actor, critic = actor.to(dev), critic.to(dev)
        self.state = TD3State(
            actor=actor,
            target_actor=copy.deepcopy(actor).requires_grad_(False),
            critic=critic,
            target_critic=copy.deepcopy(critic).requires_grad_(False),
            actor_opt=torch.optim.Adam(actor.parameters(), lr=self.cfg.lr),
            critic_opt=torch.optim.Adam(critic.parameters(), lr=self.cfg.lr),
            step=0)
        return self.state

    def _opts(self):
        st = self.state
        return (("actor_opt", st.actor_opt, list(st.actor.named_parameters())),
                ("critic_opt", st.critic_opt,
                 list(st.critic.named_parameters())))

    def load_state(self, converted: Mapping[str, Any]) -> TD3State:
        """Take over a whole agent state as ``convert.td3_state_to_torch``
        or ``export_state`` returns it. Call ``init`` first: it fixes the
        device."""
        st = self.state
        for k in self._NETS:
            getattr(st, k).load_state_dict(converted[k])
        st.step = int(converted["step"])
        for key, opt, named in self._opts():
            adam_load(opt, named, converted[key])
        return st

    def export_state(self) -> Dict[str, Any]:
        """The inverse of ``load_state`` (detached copies)."""
        st = self.state
        out: Dict[str, Any] = {
            k: {n: v.detach().clone()
                for n, v in getattr(st, k).state_dict().items()}
            for k in self._NETS}
        out["step"] = st.step
        for key, opt, named in self._opts():
            out[key] = adam_export(opt, named)
        return out

    # -- acting -----------------------------------------------------------

    @torch.no_grad()
    def select_action(self, obs: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = False,
                      noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Normalized action in [-1, 1]; exploration adds ``explore_noise``
        times a standard-normal draw (``noise``, from ``generator`` when
        absent) and clips."""
        a = self.state.actor(obs)
        if deterministic:
            return a
        if noise is None:
            noise = torch.randn(a.shape, generator=generator, device=a.device,
                                dtype=a.dtype)
        return torch.clamp(a + self.cfg.explore_noise * noise, -1.0, 1.0)

    # -- learning ---------------------------------------------------------

    def update(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """One gradient update on ``batch`` (as ``buffer.sample`` returns
        it), in place. ``noise``: the standard-normal draw of the target
        policy smoothing, (B, A) over the global batch; drawn from
        ``generator`` when absent, and indexed by ``batch["pos"]``, the rows'
        places in the global batch (``arange(B)`` in one process). The actor and both targets move only on
        updates whose number (from 0) divides by ``policy_delay``;
        ``actor_loss`` reports 0 on the others. Returns the three metrics as
        0-d tensors on the agent's device.

        With a ``mesh`` the batch holds this rank's rows of a global batch
        of ``batch_size``: the losses are this rank's sums over the global
        size, and the gradients and metrics are summed over the ranks."""
        cfg, st = self.cfg, self.state
        obs, action = batch["obs"], batch["action"]
        critic_params = list(st.critic.parameters())
        b = action.shape[0] if mesh is None else cfg.batch_size

        with torch.no_grad():       # smoothed target action
            if noise is None:
                noise = torch.randn((b,) + action.shape[1:],
                                    generator=generator, device=action.device,
                                    dtype=action.dtype)
            noise = torch.clamp(cfg.target_noise * noise[batch["pos"]], -cfg.noise_clip,
                                cfg.noise_clip)
            next_a = torch.clamp(st.target_actor(batch["next_obs"]) + noise,
                                 -1.0, 1.0)
            tq1, tq2 = st.target_critic(batch["next_obs"], next_a)
            target_q = (batch["reward"] + cfg.gamma * batch["discount_mask"]
                        * torch.minimum(tq1, tq2))

        q1, q2 = st.critic(obs, action)
        critic_loss = mean_over((q1 - target_q) ** 2 + (q2 - target_q) ** 2,
                                b, mesh)
        apply_grads(st.critic_opt, critic_params, all_reduce_(
            torch.autograd.grad(critic_loss, critic_params), mesh))

        # delayed policy and target updates. ``step`` is a Python int, so
        # the test costs no host read.
        if st.step % cfg.policy_delay == 0:
            actor_params = list(st.actor.parameters())
            # through the critic as it is now, after its step; the gradient
            # is taken for the actor's parameters only
            actor_loss = -mean_over(st.critic(obs, st.actor(obs))[0], b,
                                    mesh)
            apply_grads(st.actor_opt, actor_params, all_reduce_(
                torch.autograd.grad(actor_loss, actor_params), mesh))
            actor_loss = actor_loss.detach()
            with torch.no_grad():
                _polyak_(list(st.target_actor.parameters()), actor_params,
                         cfg.tau)
                _polyak_(list(st.target_critic.parameters()), critic_params,
                         cfg.tau)
        else:
            actor_loss = torch.zeros((), device=critic_loss.device)
        st.step += 1

        metrics = torch.stack([critic_loss.detach(), actor_loss,
                               mean_over(q1.detach(), b, mesh)])
        all_reduce_([metrics], mesh)
        return dict(zip(self.metric_names, metrics.unbind(0)))
