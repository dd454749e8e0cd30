"""Lockstep batched environment with auto-reset (port of
``torchdriveenv_tpu/env/batched.py``).

N envs are the leading axis of every tensor. Episode boundaries are handled
inside the step: done envs take a fresh reset state. Randomness comes from
an explicit ``torch.Generator`` on the envs' device, passed like the JAX
code passes keys.

On a CUDA device (without a mesh) the step replays its device work as a
chain of CUDA graphs cut at its spans (``StepGraphs``): the same kernels in
the same order on the same data, without the host's launch of each. The
reset's random draws stay outside the graphs, on the caller's generator.
"""

from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.maps.arrays import Assets, resolve_device
from torchdriveenv_tpu_torch.npc.policy_net import NpcGRU, default_params
from torchdriveenv_tpu_torch.ops.rasterizer_cuda import (
    prepare_obs_inputs,
    render_prepared,
)
from torchdriveenv_tpu_torch.parallel.mesh import (
    Mesh,
    map_tensors,
    offset_of,
    shard_carry,
)
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


class _Eager:
    """Runs each segment of the step as it is called: the step on the CPU,
    under a mesh, and in a batch's first call on the card."""

    def __call__(self, fn, *args):
        return fn(*args)

    @staticmethod
    def count(name: str, tensor: torch.Tensor) -> None:
        spans.count(name, tensor)


EAGER = _Eager()


def _obs_batched(cfg: EnvConfig, assets: Assets, state: core.EnvState,
                 run=EAGER) -> torch.Tensor:
    """Render every env of ``state``: the CUDA kernel for envs on the GPU,
    its plain twin on the CPU (``RendererConfig.backend`` = "auto"). ``run``
    runs its two segments, the packed inputs and the render."""
    rcfg = cfg.simulator.renderer
    suite = assets.suite

    def inputs(state):
        t = state.time0 + state.step_idx.to(torch.float32) * cfg.simulator.dt
        case = state.case.long()
        return prepare_obs_inputs(
            assets.maps, state.town, t, state.agent_states,
            state.agent_attrs, state.present, suite.waypoints[case],
            state.target_idx, suite.n_waypoints[case], fov=rcfg.obs_fov)

    def frames(town, prep):
        return render_prepared(
            assets.maps, town, prep, res=rcfg.obs_res, fov=rcfg.obs_fov,
            left_handed=rcfg.left_handed_coordinates,
            highlight_ego=rcfg.highlight_ego_vehicle, backend=rcfg.backend)

    with spans.span("env.render_inputs"):
        prep = run(inputs, state)
    return run(frames, state.town, prep)


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


def _reset_draws(cfg: EnvConfig, assets: Assets, batch: int,
                 generator: torch.Generator,
                 mesh: Optional[Mesh] = None) -> core.ResetDraws:
    """The random draws of one step's auto-reset, on ``generator``: R
    fresh states in pooled mode (reset_pool=R < B), B in exact mode. With a
    ``mesh`` B is the global batch."""
    b = mesh.num_envs if mesh is not None else batch
    pool = cfg.reset_pool
    n = pool if pool and pool < b else b
    return core.sample_reset_draws(n, generator, assets, cfg)


def _autoreset(cfg: EnvConfig, assets: Assets, next_state: core.EnvState,
               done: torch.Tensor, draws: core.ResetDraws,
               mesh: Optional[Mesh] = None, run=EAGER):
    """Auto-reset over the batch from ``draws`` (``_reset_draws``).

    Exact mode (reset_pool=0, or a batch no larger than the pool): every env
    draws its own fresh reset; done envs take it. Pooled mode (reset_pool=R
    < B): R fresh states are drawn per step and done envs consume them
    rank-ordered.

    With a ``mesh`` B is the global batch: exact mode draws all B
    resets and resets this rank's rows; pooled mode draws the whole pool on
    every rank and consumes it in global rank order.

    ``run`` runs the reset, a deterministic function of the draws.

    Returns (out_state, fresh_pool or None, pool_idx or None).
    """
    run.count("envs_reset", done)
    b = mesh.num_envs if mesh is not None else done.shape[0]
    pool = cfg.reset_pool
    if pool and pool < b:
        def pooled(next_state, done, draws):
            fresh_pool = core.reset_from_draws(cfg, assets, draws)
            out, idx = _consume_pool(next_state, done, fresh_pool, mesh)
            return out, fresh_pool, idx

        return run(pooled, next_state, done, draws)

    def exact(next_state, done, draws):
        fresh = core.reset_from_draws(cfg, assets, shard_carry(draws, mesh))
        return next_state.select(done, fresh), None, None

    return run(exact, next_state, done, draws)


def _no_obs(batch: int, cfg: EnvConfig, device) -> torch.Tensor:
    res = cfg.simulator.renderer.obs_res
    return torch.zeros((batch, 3, res, res), dtype=torch.uint8, device=device)


def _pool_obs(done, pool_obs, idx, final_obs):
    return torch.where(done[:, None, None, None], pool_obs[idx], final_obs)


def _reset_obs(done, obs, final_obs):
    return torch.where(done[:, None, None, None], obs, final_obs)


# ---------------------------------------------------------------------------
# the step as CUDA graphs
# ---------------------------------------------------------------------------


def _leaves(tree) -> List[torch.Tensor]:
    """The tensors of ``tree``, in the order ``map_tensors`` visits them."""
    out: List[torch.Tensor] = []
    map_tensors(out.append, tree)
    return out


def _graphed(device: torch.device, mesh: Optional[Mesh]) -> bool:
    """Whether the step replays CUDA graphs: on a CUDA device, without a
    mesh (whose pooled reset all-reduces over nccl)."""
    return device.type == "cuda" and mesh is None


def _capture(fn: Callable, args: tuple, ctx: dict):
    """fn(*args) captured as a CUDA graph into the memory pool of ``ctx``
    (its device; the pool and the capture stream, made at the first
    capture) -> (its replay, its outputs, which every replay rewrites in
    place)."""
    dev = ctx["device"]
    with torch.cuda.device(dev):
        if "pool" not in ctx:
            ctx["pool"] = torch.cuda.graph_pool_handle()
            ctx["stream"] = torch.cuda.Stream(dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=ctx["pool"], stream=ctx["stream"]):
            out = fn(*args)
    return graph.replay, out


class _Chain:
    """One key's step as a chain of CUDA graphs, a graph a ``run(fn,
    *args)`` of the step, replayed in the order of their capture.

    Its first call captures each segment and runs the graph at once; later
    calls replay them. The step runs on the chain's static inputs (the
    state, the actions and the reset's draws), which each call fills from
    the caller's; a segment's outputs are its graph's, rewritten by every
    replay."""

    def __init__(self, ctx: dict, inputs: tuple):
        self.ctx = ctx
        self.inputs = map_tensors(torch.clone, inputs)
        self.graphs: List[tuple] = []    # (replay, outputs)
        self.pos: Optional[int] = None   # the next to replay; None: capture

    def step(self, body: Callable, inputs: tuple):
        """body(*statics, self) on the caller's ``inputs``."""
        if self.graphs:
            for s, x in zip(_leaves(self.inputs), _leaves(inputs)):
                s.copy_(x)
            self.pos = 0
        out = body(*self.inputs, self)
        if self.pos is not None and self.pos != len(self.graphs):
            raise RuntimeError("the step ran fewer segments than it captured")
        return out

    def __call__(self, fn: Callable, *args):
        if self.pos is None:
            replay, out = _capture(fn, args, self.ctx)
            self.graphs.append((replay, out))
        else:
            replay, out = self.graphs[self.pos]
            self.pos += 1
        replay()
        return out

    def count(self, name: str, tensor: torch.Tensor) -> None:
        # the replays rewrite ``tensor``: the log keeps a copy
        if spans.enabled():
            spans.count(name, tensor.clone())


def _key(state: core.EnvState, actions: torch.Tensor) -> tuple:
    return tuple(None if t is None else (t.shape, t.dtype, t.device)
                 for t in (*vars(state).values(), actions))


class StepGraphs:
    """``body(state, actions, draws, run)`` replayed as CUDA graphs.

    Per key (the shapes, dtypes and device of the state's fields and the
    actions, and which fields are None) the first call runs eagerly, which
    warms the libraries and caches the step uses; the second captures the
    chain of graphs and runs it; later calls replay it. Each call copies
    the caller's tensors into the chain's static inputs, and the outputs
    into tensors the caller owns. The chains share one memory pool: a
    chain's temporaries are dead once its call ends, and each call copies
    its inputs in and its outputs out, so no replay writes into a tensor
    that another chain still reads. Counts ``env.eager_steps``,
    ``env.graph_captures`` and ``env.graph_replays`` in the span log."""

    def __init__(self, body: Callable, device: torch.device):
        self.body = body
        self.ctx = {"device": device}    # and the chains' pool and stream
        self.chains: Dict[tuple, _Chain] = {}
        self.warm: set = set()

    def __call__(self, state: core.EnvState, actions: torch.Tensor,
                 draws: core.ResetDraws) -> StepOutput:
        key = _key(state, actions)
        if key not in self.warm:
            self.warm.add(key)
            spans.count("env.eager_steps", 1)
            return self.body(state, actions, draws, EAGER)
        inputs = (state, actions, draws)
        chain = self.chains.get(key)
        if chain is None:
            spans.count("env.graph_captures", 1)
            chain = _Chain(self.ctx, inputs)
            out = chain.step(self.body, inputs)
            self.chains[key] = chain
        else:
            spans.count("env.graph_replays", 1)
            out = chain.step(self.body, inputs)
        return map_tensors(torch.clone, out)


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

    On a CUDA device without a mesh ``step_fn`` replays its device work as
    CUDA graphs (``StepGraphs``), a graph between each two of its spans; it
    captures them once a batch shape, and reads ``npc_params`` and the
    assets where they were then. The reset's random draws run first, on
    ``generator``, outside the graphs. Its outputs are the caller's.
    ``step_fn.graphs`` is that ``StepGraphs``, None where the step is eager.
    """
    dev = assets.device
    if cfg.npc_mode == "policy" and npc_params is None:
        npc_params = default_params(dev)

    def obs_of(state: core.EnvState, run=EAGER) -> torch.Tensor:
        with spans.span("env.render"):
            if render:
                return _obs_batched(cfg, assets, state, run)
            b = state.town.shape[0]
            return run(lambda: _no_obs(b, cfg, dev))

    def reset_fn(generator: torch.Generator, num_envs: int,
                 cases: Optional[torch.Tensor] = None):
        """cases: optional (B,) fixed scenario indices."""
        state = core.reset(cfg, assets, num_envs, generator, case=cases,
                           mesh=mesh)
        return state, obs_of(state)

    def npc_of(state):
        return core.npc_phase(cfg, assets, state, npc_params)

    def physics_of(state, actions, npc):
        return core.physics_phase(cfg, assets, state, actions, npc)

    def step(state: core.EnvState, actions: torch.Tensor,
             draws: core.ResetDraws, run) -> StepOutput:
        with spans.span("env.core"):
            with spans.span("env.npc"):
                npc = run(npc_of, state)
            next_state, reward, term, trunc, info = run(
                physics_of, state, actions, npc)
        done = run(operator.or_, term, trunc)
        if not with_final_obs:
            with spans.span("env.autoreset"):
                out_state, _, _ = _autoreset(cfg, assets, next_state, done,
                                             draws, mesh, run)
            return StepOutput(out_state, obs_of(out_state, run), reward,
                              term, trunc, info)

        final_obs = obs_of(next_state, run)
        with spans.span("env.autoreset"):
            out_state, fresh_pool, idx = _autoreset(
                cfg, assets, next_state, done, draws, mesh, run)
        if not render:
            obs = final_obs
        elif fresh_pool is not None:
            obs = run(_pool_obs, done, obs_of(fresh_pool, run), idx,
                      final_obs)
        else:
            obs = run(_reset_obs, done, obs_of(out_state, run), final_obs)
        return StepOutput(out_state, obs, reward, term, trunc, info,
                          final_obs=final_obs)

    graphs = StepGraphs(step, dev) if _graphed(dev, mesh) else None

    # no autograd graph: a trainable ``npc_params`` would chain one through
    # ``npc_hidden`` from step to step
    @torch.no_grad()
    def step_fn(state: core.EnvState, actions: torch.Tensor,
                generator: torch.Generator) -> StepOutput:
        with spans.span("env.step"):
            # the reset's draws, first: nothing else in the step draws
            with spans.span("env.autoreset"):
                draws = _reset_draws(cfg, assets, state.town.shape[0],
                                     generator, mesh)
            if graphs is not None:
                return graphs(state, actions, draws)
            return step(state, actions, draws, EAGER)

    step_fn.graphs = graphs
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
