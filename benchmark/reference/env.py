"""The benchmark's reference: one step of a batch of envs with the pooled
auto-reset and the observation, as the port's ``env/batched.py`` step runs
it in one process, with the plain twin of the rasterizer kernel.

A frozen copy, which later changes to the port do not reach. It runs on
any device; the frames are rendered in blocks of envs so that the twin's
(B, 8, 64, 64) temporaries stay small.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from . import core
from .arrays import Assets
from .config import EnvConfig
from .render import prepare_obs_inputs, render_obs_torch

RENDER_BLOCK = 256      # envs per block of the twin's render


def observe(cfg: EnvConfig, assets: Assets, state: core.EnvState,
            block: int = RENDER_BLOCK) -> torch.Tensor:
    """(B, 3, res, res) uint8 frames of every env of ``state``."""
    rcfg = cfg.simulator.renderer
    t = state.time0 + state.step_idx.to(torch.float32) * cfg.simulator.dt
    case = state.case.long()
    prep = prepare_obs_inputs(
        assets.maps, state.town, t, state.agent_states, state.agent_attrs,
        state.present, assets.suite.waypoints[case], state.target_idx,
        assets.suite.n_waypoints[case], fov=rcfg.obs_fov)
    frames = []
    for lo in range(0, state.town.shape[0], block):
        rows = [x[lo:lo + block] for x in (state.town,) + tuple(prep)]
        frames.append(render_obs_torch(
            assets.maps, *rows, res=rcfg.obs_res, fov=rcfg.obs_fov,
            left_handed=rcfg.left_handed_coordinates,
            highlight_ego=rcfg.highlight_ego_vehicle))
    return torch.cat(frames)


def autoreset(cfg: EnvConfig, assets: Assets, next_state: core.EnvState,
              done: torch.Tensor, generator: torch.Generator):
    """Done envs take fresh states. Pooled mode (``reset_pool`` < B): the
    pool's states are drawn and done envs take them in rank order, reused
    modulo the pool; else every env draws its own. -> (state, fresh pool or
    None, pool index per env or None)."""
    b = done.shape[0]
    pool = cfg.reset_pool
    if pool and pool < b:
        fresh_pool = core.reset(cfg, assets, pool, generator)
        idx = torch.remainder(torch.cumsum(done, dim=0) - 1, pool)
        return next_state.select(done, fresh_pool.take(idx)), fresh_pool, idx
    fresh = core.reset(cfg, assets, b, generator)
    return next_state.select(done, fresh), None, None


@torch.no_grad()
def step(cfg: EnvConfig, assets: Assets, state: core.EnvState,
         actions: torch.Tensor, generator: torch.Generator,
         npc_params=None, with_final_obs: bool = False) -> Dict:
    """One step of every env -> {"state", "obs", "reward", "terminated",
    "truncated", "info"} and, with ``with_final_obs``, "final_obs": the
    frames before the auto-reset (the pool's frames are rendered a second
    time for the done envs' new observations)."""
    next_state, reward, term, trunc, info = core.step(
        cfg, assets, state, actions, npc_params=npc_params)
    done = term | trunc
    out = dict(reward=reward, terminated=term, truncated=trunc, info=info)
    if not with_final_obs:
        out_state, _, _ = autoreset(cfg, assets, next_state, done, generator)
        return dict(out, state=out_state, obs=observe(cfg, assets, out_state))
    final_obs = observe(cfg, assets, next_state)
    out_state, fresh_pool, idx = autoreset(cfg, assets, next_state, done,
                                           generator)
    d = done[:, None, None, None]
    if fresh_pool is not None:
        obs = torch.where(d, observe(cfg, assets, fresh_pool)[idx], final_obs)
    else:
        obs = torch.where(d, observe(cfg, assets, out_state), final_obs)
    return dict(out, state=out_state, obs=obs, final_obs=final_obs)


def reset(cfg: EnvConfig, assets: Assets, n: int,
          generator: torch.Generator) -> Dict:
    """The first reset of n envs -> {"state", "obs"}."""
    state = core.reset(cfg, assets, n, generator)
    return dict(state=state, obs=observe(cfg, assets, state))


def state_from(fields: Optional[object]) -> core.EnvState:
    """A reference ``EnvState`` over the same tensors as any object with
    the state's field attributes (the program's state, read, not copied)."""
    names = core._FIELDS + ("npc_hidden",)
    return core.EnvState(**{k: getattr(fields, k) for k in names})
