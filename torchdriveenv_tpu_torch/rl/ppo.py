"""PPO learner and GAE (port of ``torchdriveenv_tpu/rl/ppo.py``).

SB3's PPO baseline of the reference (``batch_size=256, n_epochs=5,
ent_coef=0.01``) with SB3 defaults otherwise: lr 3e-4, n_steps 2048 per env,
gamma 0.99, gae_lambda 0.95, clip 0.2, vf_coef 0.5, max_grad_norm 0.5.

The rollout arrives as time-major tensors from the on-policy train step
(``parallel/train_step.py``); GAE and the epoch / minibatch loop run on the
rollout's device with no host read. The agent holds its network and
optimizer (``PPOState``) and updates them in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from torchdriveenv_tpu_torch.maps.arrays import exact_div, resolve_device
from torchdriveenv_tpu_torch.models.policies import (
    GaussianActorCritic,
    gaussian_entropy,
    gaussian_log_prob,
)
from torchdriveenv_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_,
    mean_over,
)
from torchdriveenv_tpu_torch.rl.optim import (
    adam_export,
    adam_load,
    apply_grads,
    clip_by_global_norm_,
)
from torchdriveenv_tpu_torch.utils import spans


@dataclasses.dataclass
class PPOConfig:
    lr: float = 3e-4
    n_steps: int = 2048           # per env (SB3 default)
    batch_size: int = 256
    n_epochs: int = 5
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_range: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5


@dataclasses.dataclass
class PPOState:
    net: GaussianActorCritic
    opt: torch.optim.Adam
    step: int = 0                   # updates (whole rollouts) taken


def bootstrap_truncated_rewards(reward, terminated, truncated, v_final,
                                gamma):
    """SB3's timeout handling: on a time-limit truncation the collected
    reward is augmented with ``gamma * V(terminal_observation)`` before GAE.
    Real terminations (collision, offroad, light) are not bootstrapped:
    their value is zero. GAE still cuts at done; the bootstrap rides in on
    the reward. In this env success is reaching the truncation, so zeroing
    the value there would bias the trajectories the learner must value
    highest."""
    boot = truncated & ~terminated
    return reward + gamma * torch.where(boot, v_final,
                                        torch.zeros_like(v_final))


def compute_gae(rewards, values, dones, last_value, gamma, lam):
    """Time-major GAE. rewards / values / dones: (T, E); last_value: (E,).
    Returns (advantages, returns), each (T, E).

    ``dones`` marks an episode's end AT step t (the next state belongs to a
    new episode); advantage propagation and bootstrap are both cut there.
    Time-limit truncations must already be folded into ``rewards`` by
    ``bootstrap_truncated_rewards``."""
    nonterm = 1.0 - dones.to(torch.float32)
    advs = torch.empty_like(rewards)
    adv_next, v_next = torch.zeros_like(last_value), last_value
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next * nonterm[t] - values[t]
        adv_next = delta + gamma * lam * nonterm[t] * adv_next
        advs[t] = adv_next
        v_next = values[t]
    return advs, advs + values


class ActorCriticAgent:
    """What PPO and A2C share: a ``GaussianActorCritic``, one Adam behind a
    global-norm clip, acting, and carrying the state in and out. A subclass
    sets ``config_cls`` / ``state_cls`` / ``adam_eps`` and adds ``update``."""

    metric_names = ("loss", "pg_loss", "v_loss", "entropy")
    config_cls: Any = None
    state_cls: Any = None
    adam_eps = 1e-8

    def __init__(self, cfg=None, obs_channels: int = 9,
                 compute_dtype=torch.bfloat16):
        self.cfg = cfg if cfg is not None else self.config_cls()
        self.obs_channels = obs_channels
        self.compute_dtype = compute_dtype
        self.state = None

    # -- state ------------------------------------------------------------

    def init(self, seed: int = 0, obs_res: int = 64, device=None):
        """A fresh network (initialised from ``seed``) and its optimizer, on
        ``device`` (default: the GPU)."""
        dev = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = GaussianActorCritic(self.obs_channels, obs_res=obs_res,
                                      compute_dtype=self.compute_dtype)
        net = net.to(dev)
        opt = torch.optim.Adam(net.parameters(), lr=self.cfg.lr,
                               eps=self.adam_eps)
        self.state = self.state_cls(net=net, opt=opt, step=0)
        return self.state

    def load_state(self, converted: Mapping[str, Any]):
        """Take over a whole agent state as ``convert.ppo_state_to_torch``
        or ``export_state`` returns it. Call ``init`` first: it fixes the
        device."""
        st = self.state
        st.net.load_state_dict(converted["net"])
        st.step = int(converted["step"])
        adam_load(st.opt, list(st.net.named_parameters()), converted["opt"])
        return st

    def export_state(self) -> Dict[str, Any]:
        """The inverse of ``load_state`` (detached copies)."""
        st = self.state
        return {
            "net": {n: v.detach().clone()
                    for n, v in st.net.state_dict().items()},
            "opt": adam_export(st.opt, list(st.net.named_parameters())),
            "step": st.step,
        }

    # -- acting -----------------------------------------------------------

    @torch.no_grad()
    def select_action(self, obs: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      deterministic: bool = False,
                      noise: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (the RAW normalized action sample, its log-prob, the
        value). ``noise``: the standard-normal draw, shaped like the action;
        drawn from ``generator`` when absent.

        SB3 stores the unclipped Gaussian sample in the rollout and clips
        only the copy sent to the env: storing the clipped action would make
        the log-prob recomputed at update time disagree with the sampled one
        for boundary samples. The clip lives in ``scale_action``."""
        mu, log_std, value = self.state.net(obs)
        if deterministic:
            return mu, torch.zeros_like(value), value
        if noise is None:
            noise = torch.randn(mu.shape, generator=generator,
                                device=mu.device, dtype=mu.dtype)
        a = mu + torch.exp(log_std) * noise
        return a, gaussian_log_prob(mu, log_std, a), value

    @torch.no_grad()
    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return self.state.net(obs)[2]

    # -- learning ---------------------------------------------------------

    def _step(self, loss: torch.Tensor, mesh: Optional[Mesh] = None) -> None:
        """Gradient of ``loss``, summed over the ranks of a ``mesh``,
        optax's global-norm clip (of the global gradient, as optax clips
        under GSPMD), one Adam step."""
        st = self.state
        params = list(st.net.parameters())
        grads = list(torch.autograd.grad(loss, params))
        all_reduce_(grads, mesh)
        clip_by_global_norm_(grads, self.cfg.max_grad_norm)
        apply_grads(st.opt, params, grads)


class PPO(ActorCriticAgent):
    """Holds the config and, after ``init`` or ``load_state``, the agent's
    state (``self.state``)."""

    config_cls = PPOConfig
    state_cls = PPOState
    adam_eps = 1e-5

    def update(self, rollout: Dict[str, torch.Tensor],
               last_value: torch.Tensor,
               generator: Optional[torch.Generator] = None,
               perms: Optional[torch.Tensor] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
        """One full PPO update (epochs x minibatches) on a time-major
        rollout: obs (T, E, C, H, W) uint8, action, log_prob, value, reward
        (truncations bootstrapped), done. In place.

        ``perms``: (n_epochs, T * E) int64, each row a permutation of the
        flattened rollout; drawn with ``torch.randperm`` from ``generator``
        (on the rollout's device) when absent. Each epoch walks its
        permutation in ``T * E // batch_size`` minibatches and drops the
        remainder. Returns the four metrics, means over every minibatch, as
        0-d tensors.

        With a ``mesh`` the rollout holds this rank's envs: the
        permutations run over the GLOBAL ``T * E`` on every rank, each
        minibatch takes the rows this rank owns (a synchronizing
        ``nonzero``: their number depends on the permutation), the
        advantages are normalized with all-reduced sums, the losses are this
        rank's sums over the minibatch size and the gradients are summed
        before the clip.

        Spans (``utils/spans.py``, recorded only while someone looks):
        ``ppo.gae``, ``ppo.grad_step`` around each gradient step and, under
        a mesh, ``ppo.owned_rows`` around the owned-row read (its host time
        is the wait for the device)."""
        cfg, st = self.cfg, self.state
        with torch.no_grad(), spans.span("ppo.gae"):
            advs, returns = compute_gae(rollout["reward"], rollout["value"],
                                        rollout["done"], last_value,
                                        cfg.gamma, cfg.gae_lambda)
        t, e = advs.shape
        e_all = e if mesh is None else mesh.num_envs
        n = t * e_all
        m = cfg.batch_size
        if n < m:
            raise ValueError(f"a rollout of {t} x {e_all} = {n} transitions "
                             f"cannot fill a minibatch of {m}")
        obs = rollout["obs"].reshape((t * e,) + rollout["obs"].shape[2:])
        action = rollout["action"].reshape(t * e, -1)
        old_logp = rollout["log_prob"].reshape(t * e)
        advs, returns = advs.reshape(t * e), returns.reshape(t * e)
        if perms is None:
            perms = torch.stack([
                torch.randperm(n, generator=generator, device=advs.device)
                for _ in range(cfg.n_epochs)])

        rows = []
        for epoch in range(cfg.n_epochs):
            for mb in range(n // m):
                with spans.span("ppo.grad_step"):
                    idx = perms[epoch, mb * m:(mb + 1) * m]
                    if mesh is not None:
                        with spans.span("ppo.owned_rows"):
                            idx = _owned_rows(idx, mesh, e)
                    mu, log_std, value = st.net(obs[idx])
                    logp = gaussian_log_prob(mu, log_std, action[idx])
                    ratio = torch.exp(logp - old_logp[idx])
                    adv = _normalized(advs[idx], m, mesh)
                    clipped = torch.clamp(ratio, 1 - cfg.clip_range,
                                          1 + cfg.clip_range) * adv
                    pg_loss = -mean_over(torch.minimum(ratio * adv, clipped),
                                         m, mesh)
                    v_loss = mean_over((value - returns[idx]) ** 2, m, mesh)
                    ent = mean_over(gaussian_entropy(log_std), m, mesh)
                    loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * ent
                    self._step(loss, mesh)
                    rows.append(
                        torch.stack([loss, pg_loss, v_loss, ent]).detach())
        st.step += 1
        means = torch.stack(rows).mean(0)
        all_reduce_([means], mesh)
        return dict(zip(self.metric_names, means.unbind(0)))


def _owned_rows(idx: torch.Tensor, mesh: Mesh, e: int) -> torch.Tensor:
    """The local flat rows (``t * e + env - lo``) of the global flat
    indices ``idx`` (``t * num_envs + env``) whose env this rank owns."""
    t_, env = idx // mesh.num_envs, idx % mesh.num_envs
    own = torch.nonzero((env >= mesh.lo) & (env < mesh.hi))[:, 0]
    return t_[own] * e + env[own] - mesh.lo


def _normalized(adv: torch.Tensor, m: int, mesh: Optional[Mesh]
                ) -> torch.Tensor:
    """Advantages normalized over the minibatch of ``m`` rows (population
    std), from sums over the rows of every rank (two all-reduces)."""
    mean = adv.sum().reshape(1)
    all_reduce_([mean], mesh)
    mean = exact_div(mean, m)
    var = ((adv - mean) ** 2).sum().reshape(1)
    all_reduce_([var], mesh)
    return (adv - mean) / (torch.sqrt(exact_div(var, m)) + 1e-8)
