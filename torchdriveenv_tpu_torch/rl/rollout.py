"""Rollout machinery: frame stacking and the on- / off-policy collectors
(port of ``torchdriveenv_tpu/rl/rollout.py``).

The stacked observation travels with the env state in a ``RolloutState``.
The stack holds the last ``frame_stack`` single frames channel-concatenated
oldest first; after an auto-reset it is refilled with the new episode's
first frame repeated. Randomness comes from the caller's
``torch.Generator``, which takes the place of the JAX code's key.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from torchdriveenv_tpu_torch.env.batched import StepOutput


@dataclasses.dataclass
class RolloutState:
    env_state: Any              # batched EnvState
    obs_stack: torch.Tensor     # (E, S*C, H, W) uint8


def init_stack(obs: torch.Tensor, frame_stack: int) -> torch.Tensor:
    """First-frame-repeated stack (E, S*C, H, W) from single frames
    (E, C, H, W)."""
    return obs.repeat(1, frame_stack, 1, 1)


def update_stack(stack: torch.Tensor, new_frame: torch.Tensor,
                 done: torch.Tensor) -> torch.Tensor:
    """Shift in the newest frame; refill on an episode boundary."""
    c = new_frame.shape[1]
    shifted = torch.cat([stack[:, c:], new_frame], dim=1)
    refilled = new_frame.repeat(1, stack.shape[1] // c, 1, 1)
    return torch.where(done[:, None, None, None], refilled, shifted)


def make_collector(step_fn: Callable[..., StepOutput], select_action: Callable,
                   frame_stack: int,
                   scale_action: Callable[[torch.Tensor], torch.Tensor]):
    """On-policy collector: ``n_steps`` env steps, returning time-major
    tensors.

    select_action(obs_stack, generator) -> (norm_action, log_prob, value).
    step_fn(env_state, action, generator) -> StepOutput.
    """
    del frame_stack         # the stack's depth is read off the stack itself

    def collect(rs: RolloutState, n_steps: int, generator: torch.Generator
                ) -> Tuple[RolloutState, Dict[str, Any]]:
        rows = []
        for _ in range(n_steps):
            a, logp, value = select_action(rs.obs_stack, generator)
            out = step_fn(rs.env_state, scale_action(a), generator)
            done = out.terminated | out.truncated
            rows.append(dict(obs=rs.obs_stack, action=a, log_prob=logp,
                             value=value, reward=out.reward, done=done,
                             info=out.info))
            rs = RolloutState(out.state,
                              update_stack(rs.obs_stack, out.obs, done))
        data = {k: torch.stack([r[k] for r in rows]) for k in rows[0]
                if k != "info"}
        data["info"] = {k: torch.stack([r["info"][k] for r in rows])
                        for k in rows[0]["info"]}
        return rs, data

    return collect


def make_offpolicy_step(step_fn: Callable[..., StepOutput],
                        select_action: Callable, frame_stack: int,
                        scale_action: Callable[[torch.Tensor], torch.Tensor],
                        buffer_add: Callable):
    """Off-policy: one env step of all envs plus the replay insertion.

    select_action(obs_stack, generator) -> norm_action (E, A).
    The single (un-stacked) current frame is the stack's newest slice.
    """

    def one(rs: RolloutState, buf, generator: torch.Generator,
            random_action: bool = False):
        if random_action:
            a = torch.rand((rs.obs_stack.shape[0], 2), generator=generator,
                           device=rs.obs_stack.device) * 2.0 - 1.0
        else:
            a = select_action(rs.obs_stack, generator)
        out = step_fn(rs.env_state, scale_action(a), generator)
        done = out.terminated | out.truncated
        c = rs.obs_stack.shape[1] // frame_stack
        cur_frame = rs.obs_stack[:, -c:]
        final = out.final_obs if out.final_obs is not None else out.obs
        buf = buffer_add(buf, cur_frame, a, out.reward, done, out.terminated,
                         final)
        new_stack = update_stack(rs.obs_stack, out.obs, done)
        return RolloutState(out.state, new_stack), buf, out

    return one
