"""The env step's least work, counted from shapes and from the inputs.

``phase_costs`` gives each phase of the batched env step of
``env/batched.py`` (physics, the render, the pooled auto-reset with every
env done) its least bytes and operations: each input byte read once, each
output byte written once, the operations these inputs need. ``least_s``
and ``roofline`` turn them into the least time on one H100 and a measured
step's shares of its f32 and HBM peaks; ``profile_steps`` reads the
device's busy and idle share from a torch.profiler trace. The benchmark's
frozen copies of these (``benchmark/metrics/_costs.py``,
``benchmark/metrics/_trace.py``) are held equal to them by
``benchmark/tests/test_bench_yardstick.py``.

This module has no entry point. The port's throughput is measured by
the benchmark, ``python3 -m benchmark.run --workload <cell>``; phase
times come from the spans of ``utils/spans.py``: ``with
spans.recording():`` around the work, then ``spans.records()``.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Optional

import torch

from torchdriveenv_tpu_torch.config import CollisionMetric, EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.npc.policy_net import (HIDDEN, NpcGRU,
                                                   default_params)
from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc

# NVIDIA H100 SXM data sheet, at the card's full 700 W: f32 outside the
# tensor cores, HBM3
H100_PEAK_F32_FLOPS = 67e12
H100_PEAK_HBM_BYTES = 3.35e12
PHASES = ("physics", "render", "autoreset_pool_all_done")


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
    """Least work of each phase of the env step on ``state``: {phase:
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
