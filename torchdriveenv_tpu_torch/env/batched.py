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
from torchdriveenv_tpu_torch.npc.policy_net import NpcGRU, default_params
from torchdriveenv_tpu_torch.ops.rasterizer_cuda import render_observation
from torchdriveenv_tpu_torch.parallel.mesh import Mesh, offset_of
from torchdriveenv_tpu_torch.utils import spans


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
                  fresh_pool: core.EnvState, mesh: Optional[Mesh] = None):
    """Done envs take pool entries in rank order (reused modulo the pool
    size when more envs finish than the pool holds). Returns (state, idx).

    With a ``mesh`` the order is global: this rank's done envs come
    after the done envs of the lower ranks."""
    pool = fresh_pool.town.shape[0]
    count = torch.cumsum(done, dim=0)
    rank = count - 1
    if mesh is not None:
        rank = rank + offset_of(count[-1], mesh)
    idx = torch.remainder(rank, pool)
    return next_state.select(done, fresh_pool.take(idx)), idx


def _autoreset(cfg: EnvConfig, assets: Assets, next_state: core.EnvState,
               done: torch.Tensor, generator: torch.Generator,
               mesh: Optional[Mesh] = None):
    """Auto-reset over the batch.

    Exact mode (reset_pool=0, or a batch no larger than the pool): every env
    draws its own fresh reset; done envs take it. Pooled mode (reset_pool=R
    < B): R fresh states are drawn per step and done envs consume them
    rank-ordered.

    With a ``mesh`` B is the global batch: exact mode draws all B
    resets and resets this rank's rows; pooled mode draws the whole pool on
    every rank and consumes it in global rank order.

    Returns (out_state, fresh_pool or None, pool_idx or None).
    """
    spans.count("envs_reset", done)
    b = mesh.num_envs if mesh is not None else done.shape[0]
    pool = cfg.reset_pool
    if pool and pool < b:
        fresh_pool = core.reset(cfg, assets, pool, generator)
        out, idx = _consume_pool(next_state, done, fresh_pool, mesh)
        return out, fresh_pool, idx
    fresh = core.reset(cfg, assets, b, generator, mesh=mesh)
    return next_state.select(done, fresh), None, None


def _no_obs(batch: int, cfg: EnvConfig, device) -> torch.Tensor:
    res = cfg.simulator.renderer.obs_res
    return torch.zeros((batch, 3, res, res), dtype=torch.uint8, device=device)


def make_env_fns(cfg: EnvConfig, assets: Assets, render: bool = True,
                 with_final_obs: bool = False, mesh: Optional[Mesh] = None,
                 npc_params: Optional[NpcGRU] = None
                 ) -> Tuple[Callable, Callable]:
    """Batched (reset_fn, step_fn) on the assets' device.

    reset_fn(generator, num_envs, cases=None) -> (state, obs)
    step_fn(state, actions (B, 2), generator) -> StepOutput

    ``mesh``: this rank's rows of a data-parallel run
    (``parallel/mesh.py``). ``num_envs`` and ``cases`` stay global; the
    states, actions and outputs are this rank's rows; every draw is made at
    global width, so W ranks step the envs of one process.

    ``render=False`` gives a zero placeholder obs. ``with_final_obs=True``
    also returns the pre-auto-reset observation (``StepOutput.final_obs``);
    in pooled mode only the pool is rendered a second time.

    In ``npc_mode="policy"`` the GRU NPC policy ``npc_params`` (default:
    the shipped one, loaded once onto the assets' device) drives every
    step; done envs restart from a zero hidden state, as every fresh reset
    has it.
    """
    dev = assets.device
    if cfg.npc_mode == "policy" and npc_params is None:
        npc_params = default_params(dev)

    def obs_of(state: core.EnvState) -> torch.Tensor:
        with spans.span("env.render"):
            if render:
                return _obs_batched(cfg, assets, state)
            return _no_obs(state.town.shape[0], cfg, dev)

    def reset_fn(generator: torch.Generator, num_envs: int,
                 cases: Optional[torch.Tensor] = None):
        """cases: optional (B,) fixed scenario indices."""
        state = core.reset(cfg, assets, num_envs, generator, case=cases,
                           mesh=mesh)
        return state, obs_of(state)

    # no autograd graph: a trainable ``npc_params`` would chain one through
    # ``npc_hidden`` from step to step
    @torch.no_grad()
    def step_fn(state: core.EnvState, actions: torch.Tensor,
                generator: torch.Generator) -> StepOutput:
        with spans.span("env.step"):
            with spans.span("env.core"):
                next_state, reward, term, trunc, info = core.step(
                    cfg, assets, state, actions, npc_params=npc_params)
            done = term | trunc
            if not with_final_obs:
                with spans.span("env.autoreset"):
                    out_state, _, _ = _autoreset(cfg, assets, next_state,
                                                 done, generator, mesh)
                return StepOutput(out_state, obs_of(out_state), reward, term,
                                  trunc, info)

            final_obs = obs_of(next_state)
            with spans.span("env.autoreset"):
                out_state, fresh_pool, idx = _autoreset(
                    cfg, assets, next_state, done, generator, mesh)
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

    ``device=None`` means the GPU, and raises when there is none. With a
    ``mesh``, ``num_envs`` is the global count and this process holds the
    rank's rows of it. ``npc_params``: the GRU NPC policy of
    ``npc_mode="policy"`` (default: the shipped one).
    """

    def __init__(self, cfg: EnvConfig, assets: Assets, num_envs: int,
                 device=None, seed: int = 0, render: bool = True,
                 with_final_obs: bool = False, mesh: Optional[Mesh] = None,
                 npc_params: Optional[NpcGRU] = None):
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
            cfg, assets, render=render, with_final_obs=with_final_obs,
            mesh=mesh, npc_params=npc_params)

    def reset(self, cases: Optional[torch.Tensor] = None):
        return self._reset(self.generator, self.num_envs, cases)

    def step(self, state: core.EnvState, actions: torch.Tensor) -> StepOutput:
        return self._step(state, actions, self.generator)
