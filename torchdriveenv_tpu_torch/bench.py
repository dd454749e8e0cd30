"""Headline benchmark of the port: lockstep env throughput on one GPU.

Runs the batched env step of ``env/batched.py`` (bicycle kinematics for up
to 96 agents per env, IDM NPCs, OBB collision, SDF offroad, traffic
lights, waypoint reward, pooled auto-reset, and the 3x64x64 birdview by
the CUDA rasterizer) at 4096 envs on the train suite with the action
[0.3, 0.0], the same workload as the JAX package's ``bench.py``. ``--npc
policy`` drives the NPCs with the GRU policy in place of the IDM route
follower.

Prints ONE JSON line: env-steps/s, the chunk times and their CoV guard, the
obs checksum, the per-phase times (physics, render, auto-reset with every
env done) and the card's name and power limit.

    python -m torchdriveenv_tpu_torch.bench [--num_envs 4096] [--chunk 64]
        [--npc {route,policy}] [--breakdown OUT_JSON]
    torchrun --nproc_per_node W -m torchdriveenv_tpu_torch.bench --mesh

``--breakdown OUT_JSON`` also writes the phases' times beside their least
work, counted from shapes and from these inputs (``phase_costs``: each
input byte read once, each output byte written once, the operations these
inputs need), and the step's share of the H100's f32 and HBM peaks.

``--mesh`` runs the data-parallel env step (``parallel/mesh.py``) under a
launcher: every rank seeds its generator with ``--seed``, draws at global
width and steps its own rows; each chunk ends in one all-reduce of a
scalar, so the slowest rank sets the time. Rank 0 prints the line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from typing import Any, List, NamedTuple, Optional

import torch
import torch.distributed as dist

from torchdriveenv_tpu_torch.config import CollisionMetric, EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.env.batched import (
    _autoreset,
    _obs_batched,
    _reset_draws,
    make_env_fns,
)
from torchdriveenv_tpu_torch.maps.arrays import load_assets, resolve_device
from torchdriveenv_tpu_torch.npc.policy_net import (HIDDEN, NpcGRU,
                                                   default_params)
from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
from torchdriveenv_tpu_torch.parallel import mesh as pm
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

# NVIDIA H100 SXM data sheet, at the card's full 700 W: f32 outside the
# tensor cores, HBM3
H100_PEAK_F32_FLOPS = 67e12
H100_PEAK_HBM_BYTES = 3.35e12
PHASES = ("physics", "render", "autoreset_pool_all_done")


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int = 3, device="cuda", events: bool = False
             ) -> float:
    """Best-of-`iters` time of fn() in ms, after one warm-up call. By
    default the host's clock, each call ending in a synchronize of
    ``device``; with ``events`` on a GPU, CUDA events around each call
    (the device's clock). On the CPU every call returns when its work is
    done, and the host's clock is the only one."""
    on_gpu = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    fn()
    sync()
    best = float("inf")
    for _ in range(iters):
        if events and on_gpu:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            sync()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    return best


def phase_ms(cfg, assets, state, generator) -> dict:
    """Physics (core.step alone), render (the full batch) and the pooled
    auto-reset with every env done, each timed on its own."""
    n = state.town.shape[0]
    actions = torch.tensor([[0.3, 0.0]], device=assets.device).repeat(n, 1)
    done = torch.ones(n, dtype=torch.bool, device=assets.device)
    npc_params = (default_params(assets.device) if cfg.npc_mode == "policy"
                  else None)
    return {
        "physics": timed_ms(lambda: core.step(cfg, assets, state, actions,
                                              npc_params=npc_params)),
        "render": timed_ms(lambda: _obs_batched(cfg, assets, state)),
        "autoreset_pool_all_done": timed_ms(
            lambda: _autoreset(cfg, assets, state, done,
                               _reset_draws(cfg, assets, n, generator))),
    }


def traced_kernels(fn, trace_path: str):
    """fn() under torch.profiler (CPU and CUDA activity), its chrome trace
    written to `trace_path` -> (the window's wall seconds, ending in a
    synchronize; the trace's kernel events)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return window_s, [e for e in events if e.get("cat") == "kernel"]


def profile_steps(step_fn, state, actions, generator, steps: int,
                  trace_path: str) -> dict:
    """Trace `steps` env steps with torch.profiler: the chrome trace goes to
    `trace_path`; returns the device's busy and idle share of the window
    and the kernels that took most device time."""
    def run():
        nonlocal state
        for _ in range(steps):
            state = step_fn(state, actions, generator).state

    window_s, kernels = traced_kernels(run, trace_path)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy_us, end = 0.0, -float("inf")
    for lo, hi in spans:                      # union of kernel intervals
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    first, last = (spans[0][0], max(h for _, h in spans)) if spans else (0, 0)
    by_name: dict = {}
    for e in kernels:
        tot, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + e["dur"], n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "steps": steps,
        "window_s": window_s,
        "kernel_span_s": (last - first) * 1e-6,
        "device_busy_s": busy_us * 1e-6,
        "device_idle_share": 1.0 - busy_us * 1e-6 / window_s,
        "kernel_launches_per_step": len(kernels) / steps,
        "top_kernels_ms_per_step": [
            [name[:80], tot / 1e3 / steps, n // steps] for name, (tot, n) in top],
    }


# ---------------------------------------------------------------------------
# least work per phase, counted from shapes and from these inputs
# ---------------------------------------------------------------------------
# f32 operations (each elementwise operation counts one, a transcendental
# too; integer index arithmetic counts as it is written) of core.step:
#
# per (env, agent, agent) pair, the route follower's obstacle and leader
# tiles: relative position 2 sub; longitudinal and lateral offsets 4 mul,
# 2 add; heading cosine sub, cos; same direction, ahead, leader range, |lat|
# and lateral range 4 compare, abs; the pair and leader masks 5 and;
# emergency reach mul, add, compare; relative velocity 2 sub, 4 mul, 2 add,
# negate; closing time clamp, div, clamp; predicted offset mul, add;
# oncoming and predicted miss abs, 3 compare, and; emergency mask compare,
# select, 2 and; obstacle or, and; gap add, mul, sub, select; the nearest
# one min, argmin, mul
ROUTE_PAIR_OPS = 55
# per (env, agent, light), the stopline gaps: relative position 2 sub;
# offsets 4 mul, 2 add; aligned sub, cos, compare; active 3 compare, abs,
# 5 and; gap 2 sub; select; min
STOPLINE_PAIR_OPS = 24
# per (env, light): the light's state add, remainder, 2 compare, 2 select
# and its two tests 2 compare; the stopline's midpoint 2 add, 2 mul; the
# violation test: direction cos, sin, negate, 2 sub; half length 2 mul,
# add, sqrt, mul; signed distances 2 x (2 sub, 2 mul, add); lateral
# distance 2 mul, add, abs; crossing 3 compare, add, 2 and; heading sub,
# cos, compare; 3 and, or
LIGHT_OPS = 49
# per (env, agent), the route follower's own controls: heading vectors
# cos, sin, negate; lookahead mul, clamp; probe 4 mul, 2 add, 2 sub; the
# control-field gather 4 sub, 2 div, 2 round, 2 convert, 2 clamp, 2 mul,
# 2 add for the cell, and, 2 convert, 2 x (shift, and, convert, sub, div)
# to unpack it; heading error sub, add, remainder, sub and its fold abs,
# compare, add, add, remainder, sub, select; edge term 2 mul, add, mul,
# clamp; steer mul, add, clamp; gap choice compare, 2 select, clamp; curve
# cap abs, clamp, div, sqrt; cruise speed min, clamp; IDM sub, 2 mul, div,
# 2 add, clamp, div, isfinite, mul, select, clamp, div, 2 mul, 2 sub, mul,
# clamp; parked compare, mul, clamp, 2 select; no reverse negate, div, max
NPC_AGENT_OPS = 98
# per (env, agent) in policy mode, the GRU's features: heading vectors 3;
# lookahead 2; probe 8; the control-field gather 29 (as above); heading
# error and fold 11; edge term 2 mul, add; leader gap isfinite, select,
# clamp; speed gap sub, clamp; stopline gap isfinite, select, clamp; the
# nine features 4 div, sin, cos, clamp, convert
FEATURE_OPS = 72
# per hidden unit of the GRU beside its multiply-adds and biases: r and z
# 2 add, 2 sigmoid; n mul, add, tanh; h' sub, 2 mul, add; the head's tanh
GRU_HIDDEN_OPS = 12
# the GRU's output: 2 tanh, 2 mul; its rules: parked compare, mul, clamp,
# 2 select; no reverse negate, div, max
POLICY_OUT_OPS = 4 + 8
# per (env, agent), the bicycle: clamp; tan, mul, atan; add; cos, 2 mul,
# add; sin, 2 mul, add; sin, mul, div, mul, add; mul, add; 4 select
BICYCLE_OPS = 24
# per (env, other agent), the ego's SAT test: 2 sub; cos, sin, negate; 2
# mul for the half sizes; 6 half extents of 6 mul, negate, 3 add, 2 abs;
# 4 projected distances of 2 mul, add, abs; 4 overlaps of add, sub; min of
# 4 (3); clamp; the mask compare, 2 and, and its select; max
SAT_PAIR_OPS = 112
# per env, offroad: the corners 2 mul, cos, sin, 2 negate, 4 x (4 mul, 3
# add, sub); per corner a bilinear SDF sample (2 sub, 2 div, 2 sub, clamp
# 2, floor 2, convert 4, sub 2, 2 add and 2 clamp for the far taps, 4 taps
# of 2 mul, 2 add for the index, 11 for the blend) = 47; min 3, negate,
# clamp
OFFROAD_OPS = 6 + 4 * 8 + 4 * 47 + 5
# per env, the rest: times convert, mul, add twice and the step count add;
# the ego's action clamp 2; the replay index clamp; the waypoint test
# clamp, compare, 2 sub, 2 mul, add, sqrt, compare, and; the reward 2 sub,
# 2 mul, add, sqrt, compare, select, sub, cos, sub, mul, select, 2 add; the
# counters convert, 2 add; the flags compare, 3 compare, 2 or; two
# smoothness infos sub, div, abs; the front bumper before and after 2 x
# (mul, cos, sin, 2 mul, 2 add)
EGO_ENV_OPS = 64
# per (env, fixed slot), the log-replay override: 4 select
REPLAY_SLOT_OPS = 4
# the reset (auto-reset), per fresh env: the ego's start 2 sub, 2 mul,
# 2 add, mul; its heading, a nearest sample (2 sub, 2 div, 2 sub, 2
# round, 2 convert, 2 clamp, 2 mul, 2 add = 16), mul, add; the light phase
# mul
RESET_ENV_OPS = 7 + 18 + 1
# per drawn number: the generator's output 1; per scaled draw (the spawn
# jitter and the four spawn ranges): mul, add
DRAW_OPS, SCALE_OPS = 1, 2
# per (fresh env, scenario slot): 3 attribute selects, the speed select
RESET_SCEN_SLOT_OPS = 4
# per (fresh env, tail slot): the background agent's distance 2 sub, 2
# mul, add, sqrt, compare, and; the packing not, cumsum, sub, clamp,
# compare, and, 10 selects
RESET_TAIL_SLOT_OPS = 8 + 4 + 2 + 10
# per (fresh env, spawn candidate): position 4 add; two projections of
# (nearest SDF 16, nearest gradient 16, 2 convert; normalize 2 mul, add,
# sqrt, clamp, 2 div; depth sub, clamp; move 2 mul, 2 add); nearest SDF
# 16; distance to the ego 2 sub, 2 mul, add, sqrt; 4 compare, 3 and;
# heading nearest sample 16, mul, add; the ranking cumsum, sub, compare,
# and, clamp, select; the spacing test compare, and
SPAWN_CANDIDATE_OPS = 4 + 2 * (34 + 7 + 2 + 4) + 16 + 6 + 7 + 18 + 6 + 2
# per (fresh env, candidate, agent slot): 2 sub, 2 mul, add, sqrt, select,
# min
SPAWN_AGENT_PAIR_OPS = 8
# per (fresh env, candidate, candidate): 2 sub, 2 mul, add, sqrt, and,
# select, min
SPAWN_PAIR_OPS = 9
# per env taking a pool entry: cumsum, sub, remainder
CONSUME_ENV_OPS = 3
# bytes per env of the step's small outputs: reward f32, terminated and
# truncated bool; the infos: offroad, collision, traffic_light_violation,
# psi_smoothness, psi_reward, dist_reward, speed_smoothness f32,
# is_success bool, reached_waypoint_num int32
STEP_OUT_BYTES_PER_ENV = 4 + 1 + 1 + 7 * 4 + 1 + 4
# numbers one reset draws per env (core.ResetDraws, 4 bytes each): six
# scalars, the ego-only attributes (3), the spawn jitter (2 a candidate)
# and five values a candidate; of them scaled: the jitter and four ranges
DRAWS_PER_ENV = 6 + 3 + 2 * core.N_SPAWN + 5 * core.N_SPAWN
SCALED_DRAWS_PER_ENV = 2 * core.N_SPAWN + 4 * core.N_SPAWN


def _nbytes(tree: Any) -> int:
    """Bytes of every tensor field of a dataclass (``None`` fields skipped)."""
    return sum(getattr(tree, f.name).nbytes for f in dataclasses.fields(tree)
               if isinstance(getattr(tree, f.name), torch.Tensor))


def _numel(tree: Any) -> int:
    return sum(getattr(tree, f.name).numel() for f in dataclasses.fields(tree)
               if isinstance(getattr(tree, f.name), torch.Tensor))


def _supported(cfg: EnvConfig) -> None:
    if cfg.ego_only:
        raise ValueError("the cost count covers traffic envs, not ego_only")
    if cfg.simulator.collision_metric == CollisionMetric.discs:
        raise ValueError("the cost count covers the SAT collision test")


def physics_cost(cfg: EnvConfig, assets, state: core.EnvState,
                 npc_params: Optional[NpcGRU] = None) -> dict:
    """{"flops", "bytes"} of ``core.step`` on ``state``.

    bytes: every state field and the actions read once; the map, light,
    replay and waypoint elements the step gathers per env and agent (not
    the grids); the fields the step writes anew, the reward, the flags and
    the infos written once. In policy mode ``npc_hidden`` is read and
    written and the GRU's weights are read once."""
    _supported(cfg)
    maps, suite = assets.maps, assets.suite
    b, a = state.present.shape
    n_town, n_lights = maps.stop_p0.shape[:2]
    n_fixed = suite.replay_states.shape[1]
    light_rows = sum(x.nbytes for x in (maps.stop_p0, maps.stop_p1,
                                        maps.stop_dir, maps.light_phase,
                                        maps.light_mask)) // n_town
    gathered = b * (
        a * maps.npc_field.element_size()          # the control-field cell
        + 4 * 4 * maps.sdf.element_size()          # offroad: 4 corners x 4 taps
        + maps.origin[0].nbytes                    # the town's origin
        + light_rows                               # the town's stoplines
        + suite.replay_states[0, :, 0].nbytes      # the replayed slots
        + suite.replay_mask[0, :, 0].nbytes
        + suite.waypoints[0, 0].nbytes             # the target waypoint
        + suite.n_waypoints[0].nbytes)
    once = maps.light_durations.nbytes + maps.scale.nbytes
    written = (sum(x.nbytes for x in (state.agent_states, state.step_idx,
                                      state.target_idx, state.reached_num))
               + b * STEP_OUT_BYTES_PER_ENV)
    if cfg.npc_mode == "policy":
        if npc_params is None:
            npc_params = default_params(state.present.device)
        weights = list(npc_params.parameters())
        once += sum(p.nbytes for p in weights)
        written += state.npc_hidden.nbytes
        gru = (2 * sum(p.numel() for p in weights if p.dim() == 2)
               + sum(p.numel() for p in weights if p.dim() == 1)
               + GRU_HIDDEN_OPS * HIDDEN)
        agent_ops = FEATURE_OPS + gru + POLICY_OUT_OPS
    else:
        agent_ops = NPC_AGENT_OPS
    flops = b * (ROUTE_PAIR_OPS * a * a + STOPLINE_PAIR_OPS * a * n_lights
                 + (agent_ops + BICYCLE_OPS) * a + SAT_PAIR_OPS * (a - 1)
                 + LIGHT_OPS * n_lights + REPLAY_SLOT_OPS * n_fixed
                 + OFFROAD_OPS + EGO_ENV_OPS)
    actions = b * 2 * 4                            # (B, 2) f32
    nbytes = _nbytes(state) + actions + gathered + once + written
    return {"flops": flops, "bytes": nbytes}


def autoreset_cost(cfg: EnvConfig, assets, state: core.EnvState) -> dict:
    """{"flops", "bytes"} of ``_autoreset`` with every env of ``state``
    done: the fresh resets drawn (the pool, or one per env when the batch
    is no larger than the pool): their draws and states written once and
    the suite, background and map elements they gather; the next state and
    the done flags read, a fresh row read for every env and the envs'
    states written once."""
    _supported(cfg)
    maps, suite, bg = assets.maps, assets.suite, assets.background
    b, a = state.present.shape
    pool = cfg.reset_pool
    fresh = pool if pool and pool < b else b
    row = _nbytes(state) // b
    n_scen = suite.scen_states.shape[1]
    tail = a - 1 - n_scen
    candidate = (2 * (maps.sdf.element_size() + maps.sdf_gx.element_size()
                      + maps.sdf_gy.element_size())
                 + maps.sdf.element_size() + maps.dir_angle.element_size())
    gathered = (suite.case_town[0].nbytes + 2 * suite.waypoints[0, 0].nbytes
                + maps.origin[0].nbytes + maps.dir_angle[0, 0, 0].nbytes
                + bg.bg_valid[0].nbytes + suite.scen_states[0].nbytes
                + suite.scen_attrs[0].nbytes + suite.scen_mask[0].nbytes
                + core.N_SPAWN * candidate)
    if cfg.use_background_traffic:
        gathered += (bg.bg_states[0, 0, :tail].nbytes
                     + bg.bg_attrs[0, 0, :tail].nbytes
                     + bg.bg_mask[0, 0, :tail].nbytes
                     + bg.bg_density[0, 0].nbytes)
    else:
        gathered += bg.bg_attrs[0, 0, 0].nbytes     # the ego's attributes
    nbytes = (fresh * (4 * DRAWS_PER_ENV + gathered + row)
              + maps.light_durations.nbytes
              + b * (3 * row + 1))     # read, a fresh row, written; done
    per_reset = (RESET_ENV_OPS + DRAW_OPS * DRAWS_PER_ENV
                 + SCALE_OPS * SCALED_DRAWS_PER_ENV
                 + RESET_SCEN_SLOT_OPS * n_scen + RESET_TAIL_SLOT_OPS * tail
                 + core.N_SPAWN * (SPAWN_CANDIDATE_OPS
                                   + SPAWN_AGENT_PAIR_OPS * a
                                   + SPAWN_PAIR_OPS * core.N_SPAWN))
    consume = CONSUME_ENV_OPS if fresh < b else 0
    flops = fresh * per_reset + b * (consume + _numel(state) // b)
    return {"flops": flops, "bytes": nbytes}


def render_inputs(cfg: EnvConfig, assets, state: core.EnvState):
    """The kernel's inputs for every env of ``state``, as ``_obs_batched``
    prepares them: (ci, cj, nseg, env_block, agent_block, wp_block)."""
    t = state.time0 + state.step_idx.to(torch.float32) * cfg.simulator.dt
    case = state.case.long()
    return rc.prepare_obs_inputs(
        assets.maps, state.town, t, state.agent_states, state.agent_attrs,
        state.present, assets.suite.waypoints[case], state.target_idx,
        assets.suite.n_waypoints[case], fov=cfg.simulator.renderer.obs_fov)


def phase_costs(cfg: EnvConfig, assets, state: core.EnvState, prep,
                npc_params: Optional[NpcGRU] = None) -> dict:
    """Least work of each phase of ``phase_ms`` on ``state``: {phase:
    {"flops", "bytes"}}. ``prep``: ``render_inputs(cfg, assets, state)``.
    Counted from shapes and from these inputs (the render's from the
    segments and primitives that survive the kernel's culls), never from a
    trace."""
    rcfg = cfg.simulator.renderer
    render = rc.render_cost(assets.maps, state.town, *prep, res=rcfg.obs_res,
                            fov=rcfg.obs_fov,
                            left_handed=rcfg.left_handed_coordinates)
    return {
        "physics": physics_cost(cfg, assets, state, npc_params),
        "render": {k: render[k] for k in ("flops", "bytes")},
        "autoreset_pool_all_done": autoreset_cost(cfg, assets, state),
    }


def least_s(cost: dict, peak_flops: float = H100_PEAK_F32_FLOPS,
            peak_bytes: float = H100_PEAK_HBM_BYTES):
    """-> (the least seconds of ``cost`` on the card, "bytes" or
    "operations": the larger of its bytes over the HBM rate and its
    operations over the f32 rate)."""
    t_flops, t_bytes = cost["flops"] / peak_flops, cost["bytes"] / peak_bytes
    return max(t_flops, t_bytes), ("bytes" if t_bytes >= t_flops
                                   else "operations")


def roofline(costs: dict, per_step_s: float, done_share: float,
             peak_flops: float = H100_PEAK_F32_FLOPS,
             peak_bytes: float = H100_PEAK_HBM_BYTES) -> dict:
    """The step's least work and its shares of the card's peaks over a
    measured ``per_step_s``. A step is physics and render plus the
    auto-reset with every env done scaled by ``done_share``, the share of
    envs done per step."""
    scale = {"physics": 1.0, "render": 1.0,
             "autoreset_pool_all_done": done_share}
    step = {k: sum(scale[p] * costs[p][k] for p in PHASES)
            for k in ("flops", "bytes")}
    least, bound_by = least_s(step, peak_flops, peak_bytes)
    return {
        "flops_per_step": step["flops"],
        "bytes_per_step": step["bytes"],
        "flops_utilization_vs_f32_peak":
            step["flops"] / peak_flops / per_step_s,
        "hbm_bw_utilization": step["bytes"] / peak_bytes / per_step_s,
        "least_ms_per_step": least * 1e3,
        "bound_by": bound_by,
        "phases_least_ms": {p: least_s(costs[p], peak_flops, peak_bytes)[0]
                            * 1e3 for p in PHASES},
    }


def breakdown_report(num_envs: int, chunk: int, best_chunk_s: float,
                     phases: dict, costs: dict, done_share: float,
                     render_kernel_ms: float, card: str,
                     rows: Optional[dict] = None) -> dict:
    """The ``--breakdown`` file: the JAX bench's keys (``num_envs``,
    ``chunk_steps``, ``fused_per_step_ms``, ``phases_ms_per_step``,
    ``costs``, ``device``, ``roofline``), the roofline's least time and
    bound, the share of envs done per step, the kernel's time alone on the
    same inputs, and under ``--mesh`` which rows were counted."""
    per_step_s = best_chunk_s / chunk
    report = {
        "num_envs": num_envs,
        "chunk_steps": chunk,
        "fused_per_step_ms": per_step_s * 1e3,
        "phases_ms_per_step": phases,
        "costs": costs,
        "device": card,
        "done_share_per_step": done_share,
        "render_kernel_ms": render_kernel_ms,
        "roofline": roofline(costs, per_step_s, done_share),
    }
    if rows is not None:
        report["rows"] = rows
    return report




# ---------------------------------------------------------------------------
# the timed loop
# ---------------------------------------------------------------------------


class ChunkRun(NamedTuple):
    """What ``run_chunks`` measured."""

    state: Any                        # the envs' state after the last chunk
    first_s: float                    # the warm-up chunk, seconds
    times: List[float]                # this rank's timed chunks, seconds
    times_by_rank: List[List[float]]  # every rank's; ``[times]`` in one process
    reward_sum: torch.Tensor          # the last step's rewards, summed
    obs_sum: torch.Tensor             # the last step's frames, summed (int64)
    done: Optional[torch.Tensor]      # envs done while timed (own rows)


def run_chunks(step_fn, state, actions, generator, chunk: int, iters: int,
               device, mesh: Optional[pm.Mesh] = None,
               count_done: bool = False) -> ChunkRun:
    """A warm-up chunk of ``chunk`` env steps, then ``iters`` timed chunks,
    each ending in a synchronize of ``device``. With a ``mesh`` each chunk
    first ends in one all-reduce of a scalar, so the slowest rank sets
    every rank's time; after the last chunk the checksums are summed over
    the ranks and every rank's times gathered. ``count_done``: count the
    envs done over the timed chunks on the device (no host read inside the
    window)."""
    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    tick = torch.zeros(1, device=device) if mesh is not None else None
    done = (torch.zeros((), dtype=torch.int64, device=device) if count_done
            else None)

    def timed(state, done):
        t0 = time.perf_counter()
        for _ in range(chunk):
            out = step_fn(state, actions, generator)
            state = out.state
            if done is not None:
                done += (out.terminated | out.truncated).sum()
        # fold the last obs into a checksum, as the JAX bench does
        sums = (out.reward.sum(), out.obs.sum())
        pm.all_reduce_([tick], mesh)
        sync()
        return state, sums, time.perf_counter() - t0

    state, _, first_s = timed(state, None)
    times = []
    for _ in range(iters):
        state, (r_sum, o_sum), t = timed(state, done)
        times.append(t)
    times_by_rank = [times]
    if mesh is not None:
        pm.all_reduce_([r_sum, o_sum], mesh)
        by_rank = torch.zeros(mesh.world, iters, dtype=torch.float64,
                              device=device)
        by_rank[mesh.rank] = torch.tensor(times, dtype=torch.float64)
        pm.all_reduce_([by_rank], mesh)
        times_by_rank = by_rank.tolist()
    return ChunkRun(state, first_s, times, times_by_rank, r_sum, o_sum, done)


def _spread(times: List[float]):
    """-> (CoV, contended) of chunk times; warns when the machine was
    likely contended."""
    best = min(times)
    mean_t = sum(times) / len(times)
    cov = (sum((t - mean_t) ** 2 for t in times) / len(times)) ** 0.5 / mean_t
    spread = max(times) / best
    contended = spread > 2.0 or cov > 0.25
    if contended:
        print(f"WARNING: chunk-time spread {spread:.1f}x, CoV {cov:.2f}: the "
              "machine was likely contended; treat this record as suspect",
              file=sys.stderr)
    return cov, contended


def write_breakdown(path: str, cfg: EnvConfig, assets, run: ChunkRun,
                    chunk: int, phases: dict, card: str,
                    rows: Optional[dict] = None) -> dict:
    """Count the phases' work on ``run.state``, time the kernel alone on
    the same inputs, and write ``breakdown_report`` to ``path``."""
    state = run.state
    rcfg = cfg.simulator.renderer
    prep = render_inputs(cfg, assets, state)
    npc_params = (default_params(assets.device) if cfg.npc_mode == "policy"
                  else None)
    costs = phase_costs(cfg, assets, state, prep, npc_params)
    kernel_ms = timed_ms(lambda: rc.render_obs_cuda(
        assets.maps, state.town, *prep, res=rcfg.obs_res, fov=rcfg.obs_fov,
        left_handed=rcfg.left_handed_coordinates,
        highlight_ego=rcfg.highlight_ego_vehicle), iters=20,
        device=assets.device, events=True)
    b = state.town.shape[0]
    done_share = int(run.done) / (b * chunk * len(run.times))
    report = breakdown_report(b, chunk, min(run.times), phases, costs,
                              done_share, kernel_ms, card, rows)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    print(f"breakdown -> {path}: " + json.dumps(report["roofline"]),
          file=sys.stderr)
    return report


def main(argv=None) -> Optional[dict]:
    """Run the bench; print its line and return it (rank 0; other ranks of
    ``--mesh`` print nothing and return None)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=64, help="steps per timed chunk")
    ap.add_argument("--iters", type=int, default=5, help="timed chunks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no_render", action="store_true")
    ap.add_argument("--npc", default="route", choices=["route", "policy"],
                    help="NPC model: the IDM route follower (default) or the "
                    "GRU policy (npc/policy_net.py)")
    ap.add_argument("--profile", metavar="TRACE_JSON", default=None,
                    help="also trace 8 steps with torch.profiler, write the "
                    "chrome trace there and add the device's idle share and "
                    "top kernels to the output")
    ap.add_argument("--breakdown", metavar="OUT_JSON", default=None,
                    help="also write the phases' times, their least bytes "
                    "and operations counted from shapes, and the step's "
                    "share of the H100's f32 and HBM peaks to OUT_JSON "
                    "(under --mesh, rank 0's rows)")
    ap.add_argument("--mesh", action="store_true",
                    help="the data-parallel env step over the ranks of a "
                    "launcher: torchrun --nproc_per_node W -m "
                    "torchdriveenv_tpu_torch.bench --mesh")
    args = ap.parse_args(argv)
    if args.mesh and args.profile:
        ap.error("--profile traces one process: run it without --mesh")

    mesh, owned_group = None, False
    if args.mesh:
        owned_group = not dist.is_initialized()
        if not pm.maybe_init_distributed():
            raise SystemExit(
                "--mesh runs under a launcher, which this process lacks: "
                "torchrun --nproc_per_node W -m torchdriveenv_tpu_torch.bench "
                "--mesh")
        mesh = pm.make_mesh(args.num_envs)
    device = resolve_device(None)
    set_f32_precision()
    cfg = EnvConfig(npc_mode=args.npc)
    assets = load_assets("train", device=device)
    reset_fn, step_fn = make_env_fns(cfg, assets, render=not args.no_render,
                                     mesh=mesh)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, _ = reset_fn(gen, args.num_envs)
    actions = torch.tensor([[0.3, 0.0]], device=device).repeat(
        state.town.shape[0], 1)
    run = run_chunks(step_fn, state, actions, gen, args.chunk, args.iters,
                     device, mesh=mesh, count_done=bool(args.breakdown))
    if args.mesh:
        record = _mesh_record(args, run, mesh, cfg, assets, gen)
    else:
        record = _record(args, run, step_fn, actions, gen, cfg, assets)
    if record is not None:
        print(json.dumps(record))
    if owned_group:
        dist.destroy_process_group()
    return record


def _record(args, run: ChunkRun, step_fn, actions, gen, cfg, assets) -> dict:
    """The one-process line (and the breakdown file)."""
    times = run.times
    best = min(times)
    cov, contended = _spread(times)
    extra = {}
    if args.profile:
        extra["profile"] = profile_steps(step_fn, run.state, actions, gen, 8,
                                         args.profile)
    phases = phase_ms(cfg, assets, run.state, gen)
    card = card_line()
    if args.breakdown:
        write_breakdown(args.breakdown, cfg, assets, run, args.chunk, phases,
                        card)
    return {
        "metric": "env_steps_per_sec",
        "value": args.num_envs * args.chunk / best,
        "median": args.num_envs * args.chunk / sorted(times)[len(times) // 2],
        "unit": f"env-steps/s ({args.num_envs} envs, "
                f"render={not args.no_render}, npc={args.npc})",
        "chunk_steps": args.chunk,
        "first_chunk_s": run.first_s,
        "chunk_times_s": times,
        "chunk_time_cov": cov,
        **({"contention_warning": True} if contended else {}),
        "obs_checksum": int(run.obs_sum.item()),
        "reward_checksum": float(run.reward_sum.item()),
        "phases_ms_per_step": phases,
        "device": torch.cuda.get_device_name(0),
        "card": card,
        **extra,
    }


def _mesh_record(args, run: ChunkRun, mesh: Optional[pm.Mesh], cfg, assets,
                 gen) -> Optional[dict]:
    """The ``--mesh`` line, on rank 0: env-steps/s over all ranks (global
    envs x chunk over the best of the chunks' slowest-rank times; the
    median likewise), the same per rank (one card per rank under torchrun),
    every rank's chunk times and the checksums summed over the ranks. With
    ``--breakdown``, rank 0 writes the breakdown of its own rows."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if rank != 0:
        return None
    slowest = [max(chunk) for chunk in zip(*run.times_by_rank)]
    cov, contended = _spread(slowest)
    value = args.num_envs * args.chunk / min(slowest)
    card = card_line()
    if args.breakdown:
        lo, hi = (mesh.lo, mesh.hi) if mesh is not None else (0, args.num_envs)
        write_breakdown(args.breakdown, cfg, assets, run, args.chunk,
                        phase_ms(cfg, assets, run.state, gen), card,
                        rows=dict(rank=rank, world=world, lo=lo, hi=hi,
                                  global_envs=args.num_envs))
    return {
        "metric": "env_steps_per_sec",
        "value": value,
        "median": args.num_envs * args.chunk
                  / sorted(slowest)[len(slowest) // 2],
        "value_per_rank": value / world,
        "unit": f"env-steps/s ({args.num_envs} envs over {world} ranks, "
                f"render={not args.no_render}, npc={args.npc})",
        "world": world,
        "backend": dist.get_backend(),
        "envs_per_rank": run.state.town.shape[0],
        "chunk_steps": args.chunk,
        "first_chunk_s": run.first_s,
        "chunk_times_s_by_rank": run.times_by_rank,
        "slowest_chunk_times_s": slowest,
        "chunk_time_cov": cov,
        **({"contention_warning": True} if contended else {}),
        "obs_checksum": int(run.obs_sum.item()),
        "reward_checksum": float(run.reward_sum.item()),
        "device": torch.cuda.get_device_name(0),
        "card": card,
    }


if __name__ == "__main__":
    main()
