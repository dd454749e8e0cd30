"""Lockstep batched environment with auto-reset (port of
``torchdriveenv_tpu/env/batched.py``).

N envs are the leading axis of every tensor. Episode boundaries are handled
inside the step: done envs take a fresh reset state. Randomness comes from
an explicit ``torch.Generator`` on the envs' device, passed like the JAX
code passes keys.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.maps.arrays import Assets, resolve_device
from torchdriveenv_tpu_torch.npc.policy_net import default_params
from torchdriveenv_tpu_torch.ops.rasterizer_cuda import render_observation


class StepOutput(NamedTuple):
    state: Any                 # core.EnvState batch
    obs: torch.Tensor          # (B, 3, res, res) uint8 (after auto-reset)
    reward: torch.Tensor       # (B,)
    terminated: torch.Tensor   # (B,) bool
    truncated: torch.Tensor    # (B,) bool
    info: Dict[str, torch.Tensor]
    # the observation before auto-reset (the true terminal observation of
    # done envs); only with with_final_obs=True
    final_obs: Any = None


def _obs_batched(cfg: EnvConfig, assets: Assets,
                 state: core.EnvState) -> torch.Tensor:
    """Render every env of ``state``: the CUDA kernel for envs on the GPU,
    its plain twin on the CPU (``RendererConfig.backend`` = "auto")."""
    rcfg = cfg.simulator.renderer
    t = state.time0 + state.step_idx.to(torch.float32) * cfg.simulator.dt
    case = state.case.long()
    return render_observation(
        assets.maps, state.town, t,
        state.agent_states, state.agent_attrs, state.present,
        assets.suite.waypoints[case], state.target_idx,
        assets.suite.n_waypoints[case],
        res=rcfg.obs_res, fov=rcfg.obs_fov,
        left_handed=rcfg.left_handed_coordinates,
        highlight_ego=rcfg.highlight_ego_vehicle,
        backend=rcfg.backend,
    )


def _consume_pool(next_state: core.EnvState, done: torch.Tensor,
                  fresh_pool: core.EnvState):
    """Done envs take pool entries in rank order (reused modulo the pool
    size when more envs finish than the pool holds). Returns (state, idx)."""
    pool = fresh_pool.town.shape[0]
    rank = torch.cumsum(done, dim=0) - 1
    idx = torch.remainder(rank, pool)
    return next_state.select(done, fresh_pool.take(idx)), idx


def _autoreset(cfg: EnvConfig, assets: Assets, next_state: core.EnvState,
               done: torch.Tensor, generator: torch.Generator):
    """Auto-reset over the batch.

    Exact mode (reset_pool=0, or a batch no larger than the pool): every env
    draws its own fresh reset; done envs take it. Pooled mode (reset_pool=R
    < B): R fresh states are drawn per step and done envs consume them
    rank-ordered.

    Returns (out_state, fresh_pool or None, pool_idx or None).
    """
    b = done.shape[0]
    pool = cfg.reset_pool
    if pool and pool < b:
        fresh_pool = core.reset(cfg, assets, pool, generator)
        out, idx = _consume_pool(next_state, done, fresh_pool)
        return out, fresh_pool, idx
    fresh = core.reset(cfg, assets, b, generator)
    return next_state.select(done, fresh), None, None


def _no_obs(batch: int, cfg: EnvConfig, device) -> torch.Tensor:
    res = cfg.simulator.renderer.obs_res
    return torch.zeros((batch, 3, res, res), dtype=torch.uint8, device=device)


def make_env_fns(cfg: EnvConfig, assets: Assets, render: bool = True,
                 with_final_obs: bool = False) -> Tuple[Callable, Callable]:
    """Batched (reset_fn, step_fn) on the assets' device.

    reset_fn(generator, num_envs, cases=None) -> (state, obs)
    step_fn(state, actions (B, 2), generator) -> StepOutput

    ``render=False`` gives a zero placeholder obs. ``with_final_obs=True``
    also returns the pre-auto-reset observation (``StepOutput.final_obs``);
    in pooled mode only the pool is rendered a second time.

    In ``npc_mode="policy"`` the shipped GRU NPC policy is loaded once onto
    the assets' device and drives every step; done envs restart from a
    zero hidden state, as every fresh reset has it.
    """
    dev = assets.device
    npc_params = default_params(dev) if cfg.npc_mode == "policy" else None

    def obs_of(state: core.EnvState) -> torch.Tensor:
        if render:
            return _obs_batched(cfg, assets, state)
        return _no_obs(state.town.shape[0], cfg, dev)

    def reset_fn(generator: torch.Generator, num_envs: int,
                 cases: Optional[torch.Tensor] = None):
        """cases: optional (B,) fixed scenario indices."""
        state = core.reset(cfg, assets, num_envs, generator, case=cases)
        return state, obs_of(state)

    def step_fn(state: core.EnvState, actions: torch.Tensor,
                generator: torch.Generator) -> StepOutput:
        next_state, reward, term, trunc, info = core.step(
            cfg, assets, state, actions, npc_params=npc_params)
        done = term | trunc
        if not with_final_obs:
            out_state, _, _ = _autoreset(cfg, assets, next_state, done,
                                         generator)
            return StepOutput(out_state, obs_of(out_state), reward, term,
                              trunc, info)

        final_obs = obs_of(next_state)
        out_state, fresh_pool, idx = _autoreset(cfg, assets, next_state, done,
                                                generator)
        if not render:
            obs = final_obs
        else:
            d = done[:, None, None, None]
            if fresh_pool is not None:
                obs = torch.where(d, obs_of(fresh_pool)[idx], final_obs)
            else:
                obs = torch.where(d, obs_of(out_state), final_obs)
        return StepOutput(out_state, obs, reward, term, trunc, info,
                          final_obs=final_obs)

    return reset_fn, step_fn


class BatchedEnv:
    """A fixed batch of envs on one device, with its own generator.

    ``device=None`` means the GPU, and raises when there is none.
    """

    def __init__(self, cfg: EnvConfig, assets: Assets, num_envs: int,
                 device=None, seed: int = 0, render: bool = True,
                 with_final_obs: bool = False):
        self.device = resolve_device(device)
        if assets.device.type != self.device.type:
            raise ValueError(f"assets are on {assets.device}, the env on "
                             f"{self.device}")
        self.cfg = cfg
        self.assets = assets
        self.num_envs = num_envs
        self.generator = torch.Generator(device=assets.device)
        self.generator.manual_seed(seed)
        self._reset, self._step = make_env_fns(
            cfg, assets, render=render, with_final_obs=with_final_obs)

    def reset(self, cases: Optional[torch.Tensor] = None):
        return self._reset(self.generator, self.num_envs, cases)

    def step(self, state: core.EnvState, actions: torch.Tensor) -> StepOutput:
        return self._step(state, actions, self.generator)
