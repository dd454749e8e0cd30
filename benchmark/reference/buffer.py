"""On-device replay buffer with frame-stack reconstruction (the benchmark's
reference: a frozen copy of the port's ``rl/buffer.py``, one process).

Each single frame is stored once per (env, time) cell and the stack is
gathered at sample time. Episode boundaries are respected: frames older
than the sampled cell's episode start are replaced by the episode's first
frame.

Truncation bootstrapping: a transition that ended by timeout (truncated,
not terminated) bootstraps through the episode boundary with the episode's
true final observation. That frame is no buffer cell (the next cell holds
the new episode's first frame after the auto-reset), so it is kept in a
small side ring:

  term_frames (E, K, C, H, W)  terminal-frame slots, K = max(capacity/64, 8)
  term_ptr    (E,) int32       next slot per env (advances on truncation)
  term_slot   (E, N) int32     which slot holds this cell's terminal frame

``add`` writes the step's final frame into the env's next free slot every
time and advances the pointer only on truncation.

Layout: a ring over time, one row per env:
  frames      (E, N, 3, H, W) uint8
  action      (E, N, A)  normalized (-1, 1) space
  reward      (E, N)
  done        (E, N)   episode ended at this step (terminal or truncation)
  terminal    (E, N)   bootstrap cutoff (terminated, not truncated)
  ep_start    (E, N) int32 ring index of this step's episode start

``add`` updates the buffer in place and returns it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .arrays import resolve_device


@dataclasses.dataclass
class ReplayBuffer:
    frames: torch.Tensor        # (E, N, C, H, W) uint8, C = 3 (single frame)
    action: torch.Tensor        # (E, N, A)
    reward: torch.Tensor        # (E, N)
    done: torch.Tensor          # (E, N) bool
    terminal: torch.Tensor      # (E, N) bool
    ep_start: torch.Tensor      # (E, N) int32
    term_frames: torch.Tensor   # (E, K, C, H, W) uint8 truncation-obs side ring
    term_slot: torch.Tensor     # (E, N) int32 side-ring slot of this cell
    term_ptr: torch.Tensor      # (E,) int32 next free side-ring slot
    is_demo: torch.Tensor       # (E, N) bool: the action came from the
    #                             scripted demonstration driver (rl/demo.py)
    pos: torch.Tensor           # () int32 next write index
    filled: torch.Tensor        # () int32 number of valid cells per env
    cur_ep_start: torch.Tensor  # (E,) int32 ring index of the running episode's start


def create(num_envs: int, capacity: int, obs_shape: Tuple[int, int, int],
           action_dim: int = 2, device=None) -> ReplayBuffer:
    dev = resolve_device(device)
    c, h, w = obs_shape
    e, n = num_envs, capacity
    k = max(capacity // 64, 8)

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return ReplayBuffer(
        frames=zeros((e, n, c, h, w), torch.uint8),
        action=zeros((e, n, action_dim), torch.float32),
        reward=zeros((e, n), torch.float32),
        done=zeros((e, n), torch.bool),
        terminal=zeros((e, n), torch.bool),
        ep_start=zeros((e, n), torch.int32),
        term_frames=zeros((e, k, c, h, w), torch.uint8),
        term_slot=zeros((e, n), torch.int32),
        term_ptr=zeros((e,), torch.int32),
        is_demo=zeros((e, n), torch.bool),
        pos=zeros((), torch.int32),
        filled=zeros((), torch.int32),
        cur_ep_start=zeros((e,), torch.int32),
    )


def add(buf: ReplayBuffer, frame: torch.Tensor, action: torch.Tensor,
        reward: torch.Tensor, done: torch.Tensor, terminal: torch.Tensor,
        final_frame: torch.Tensor,
        demo_mask: Optional[torch.Tensor] = None) -> ReplayBuffer:
    """Append one transition per env, in place.

    frame: (E, C, H, W) the obs the action was computed from; reward / done
    of the resulting step. final_frame: (E, C, H, W) the obs after the step
    and before any auto-reset (``StepOutput.final_obs``), the episode's
    terminal obs when done; kept in the side ring for truncated episodes.

    The write index lives on the device (no host read): cell ``pos % N`` of
    every env is addressed with an index tensor.
    """
    e, n = buf.frames.shape[:2]
    k = buf.term_frames.shape[1]
    i = torch.remainder(buf.pos, n).long()                   # ()
    col = i.expand(e)
    env_ids = torch.arange(e, device=buf.frames.device)
    trunc_only = done & ~terminal
    slot = torch.remainder(buf.term_ptr, k)                  # (E,) int32

    buf.frames[env_ids, col] = frame
    buf.action[env_ids, col] = action
    buf.reward[env_ids, col] = reward
    buf.done[env_ids, col] = done
    buf.terminal[env_ids, col] = terminal
    buf.ep_start[env_ids, col] = buf.cur_ep_start
    # the next free slot is written every time; the pointer only advances
    # (freezing the frame) when this step truncated the episode
    buf.term_frames[env_ids, slot.long()] = final_frame
    buf.term_slot[env_ids, col] = slot
    buf.term_ptr += trunc_only.to(torch.int32)
    buf.is_demo[env_ids, col] = (torch.zeros_like(done) if demo_mask is None
                                 else demo_mask)
    buf.cur_ep_start = torch.where(
        done, torch.remainder(i + 1, n).to(torch.int32), buf.cur_ep_start)
    buf.pos += 1
    buf.filled = torch.clamp(buf.filled + 1, max=n)
    return buf


def _stack_at(buf: ReplayBuffer, env_idx: torch.Tensor, idx: torch.Tensor,
              frame_stack: int) -> torch.Tensor:
    """Frame-stacked obs (B, C*frame_stack, H, W) ending at ring indices
    ``idx`` (B,) of envs ``env_idx`` (B,), clamped to the episode start
    recorded for each cell: one batched gather."""
    n = buf.frames.shape[1]
    start = buf.ep_start[env_idx, idx].long()
    # age of the sampled cell within its episode (ring distance start -> idx)
    age = torch.remainder(idx - start, n)
    offs = torch.arange(frame_stack - 1, -1, -1, device=idx.device)  # oldest..newest
    offs = torch.minimum(offs[None, :], age[:, None])   # clamp at episode start
    ids = torch.remainder(idx[:, None] - offs, n)                    # (B, S)
    f = buf.frames[env_idx[:, None], ids]                            # (B, S, C, H, W)
    return f.reshape((f.shape[0], frame_stack * f.shape[2]) + f.shape[3:])


def sample(buf: ReplayBuffer, batch_size: int, frame_stack: int = 3,
           generator: Optional[torch.Generator] = None):
    """Uniform sample of transitions with stacked obs / next_obs.

    Returns dict(obs (B, S*C, H, W) uint8, action, reward, next_obs,
    discount_mask, done, is_demo, pos):
      - terminated cells: discount 0 (next_obs content is irrelevant);
      - truncated cells: discount 1 and next_obs is the episode's true final
        observation (the side-ring frame appended to the cell's own stack);
      - ordinary cells: discount 1, next_obs from the following cell;
      - ``pos``: ``arange(B)``, which indexes the learners' noise.

    The draws: ``env_idx`` in [0, E) and ``off`` in [0, max(filled - 1,
    1)), two ``torch.randint`` draws from ``generator``.
    """
    e, n = buf.frames.shape[:2]
    c = buf.frames.shape[2]
    dev = buf.frames.device
    env_idx = torch.randint(0, e, (batch_size,), generator=generator,
                            device=dev)
    upper = torch.clamp(buf.filled - 1, min=1)
    off = torch.randint(0, 2 ** 31 - 1, (batch_size,), generator=generator,
                        device=dev) % upper
    pos = torch.arange(env_idx.shape[0], device=dev)
    # sample backwards from the last complete cell
    idx = torch.remainder(buf.pos.long() - 2 - off, n)

    obs = _stack_at(buf, env_idx, idx, frame_stack)
    done = buf.done[env_idx, idx]
    terminal = buf.terminal[env_idx, idx]
    trunc_only = done & ~terminal
    nxt = torch.remainder(idx + 1, n)
    next_obs = _stack_at(buf, env_idx, nxt, frame_stack)
    # truncated cells: the true final obs is this cell's stack shifted by the
    # side-ring terminal frame
    term_f = buf.term_frames[env_idx, buf.term_slot[env_idx, idx].long()]
    trunc_next = torch.cat([obs[:, c:], term_f], dim=1)
    next_obs = torch.where(trunc_only[:, None, None, None], trunc_next,
                           next_obs)
    return dict(
        obs=obs,
        action=buf.action[env_idx, idx],
        reward=buf.reward[env_idx, idx],
        next_obs=next_obs,
        discount_mask=1.0 - terminal.to(torch.float32),
        done=done,
        is_demo=buf.is_demo[env_idx, idx],
        pos=pos,
    )
