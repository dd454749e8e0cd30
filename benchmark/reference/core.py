"""The benchmark's reference: batched ``reset`` and ``step``.

A frozen copy of the port's ``env/core.py`` (plain torch, one process),
which later changes to the port do not reach.

Every function works on a batch of envs: ``EnvState`` holds tensors with a
leading env axis ``B``, where the JAX code ``vmap``s a per-env function.

torch cannot reproduce JAX's threefry streams, so the reset is split in two:
``sample_reset_draws`` draws every random quantity the JAX ``core.reset``
consumes (from a ``torch.Generator``), and ``reset_from_draws`` is a
deterministic function of those draws. Tests feed it JAX's own draws.

In ``npc_mode="policy"`` the GRU of ``npc/policy_net.py`` drives the NPCs
and its hidden state rides in ``EnvState.npc_hidden``; in route mode that
field is ``None``.

Agent slot layout (ego first):
    slot 0            ego
    slots 1..S        scenario-predefined agents
    slots S+1..A-1    background traffic + locally spawned traffic
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import CollisionMetric, EnvConfig
from .arrays import (
    Assets,
    MapArrays,
    device_constant,
    exact_div,
    sample_dir_angle,
    sample_sdf_grad,
    sample_sdf_nearest,
)
from . import policy_net
from .route_follow import npc_actions
from .bicycle import bicycle_step
from .collision import ego_collision, ego_collision_discs
from .offroad import compute_offroad
from .traffic_lights import traffic_light_violation
from .waypoints import waypoint_reached

# action bounds [accel, steer]
ACTION_LOW = (-1.0, -0.3)
ACTION_HIGH = (1.0, 0.3)

# local traffic genesis (stand-in for the reference's IAI initialize)
SPAWN_GRID = 8              # 8x8 candidate cells over the FOV window
SPAWN_FOV = 120.0
SPAWN_JITTER = 11.0         # uniform jitter inside a cell (m)
SPAWN_MIN_EGO_DIST = 20.0
SPAWN_MIN_AGENT_DIST = 9.0
SPAWN_SDF_MARGIN = 1.2      # candidate must be this deep inside the road (m)
SPAWN_PROJECT_MAX = 14.0    # max per-iteration SDF-gradient projection (m)
TOTAL_AGENT_TARGET = 95
BG_FAR_DIST = 100.0         # background agents nearer than this are replaced
N_SPAWN = SPAWN_GRID * SPAWN_GRID

_FIELDS = ("town", "case", "agent_states", "agent_attrs", "present",
           "npc_target_speed", "step_idx", "time0", "target_idx",
           "reached_num")
_DTYPES = dict(town=torch.int32, case=torch.int32,
               agent_states=torch.float32, agent_attrs=torch.float32,
               present=torch.bool, npc_target_speed=torch.float32,
               step_idx=torch.int32, time0=torch.float32,
               target_idx=torch.int32, reached_num=torch.int32)


@dataclasses.dataclass
class EnvState:
    """Simulation state of a batch of envs (leading axis B on every field)."""

    town: torch.Tensor              # (B,) int32
    case: torch.Tensor              # (B,) int32 scenario index
    agent_states: torch.Tensor      # (B, A, 4) [x, y, psi, speed]
    agent_attrs: torch.Tensor       # (B, A, 3) [length, width, rear_axis_offset]
    present: torch.Tensor           # (B, A) bool
    npc_target_speed: torch.Tensor  # (B, A) desired cruise speed
    step_idx: torch.Tensor          # (B,) int32 steps taken this episode
    time0: torch.Tensor             # (B,) f32 traffic-light phase offset (s)
    target_idx: torch.Tensor        # (B,) int32 current waypoint target
    reached_num: torch.Tensor       # (B,) int32 waypoints reached
    # (B, A, HIDDEN) GRU state in npc_mode="policy", else None
    npc_hidden: Optional[torch.Tensor] = None

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)

    def _fields(self) -> Tuple[str, ...]:
        return _FIELDS + (("npc_hidden",) if self.npc_hidden is not None
                          else ())

    def select(self, done: torch.Tensor, fresh: "EnvState") -> "EnvState":
        """Per env: ``fresh`` where ``done``, else this state."""
        def sel(f, n):
            d = done.reshape(done.shape + (1,) * (n.dim() - done.dim()))
            return torch.where(d, f, n)
        return EnvState(**{k: sel(getattr(fresh, k), getattr(self, k))
                           for k in self._fields()})

    def take(self, idx: torch.Tensor) -> "EnvState":
        """Gather envs ``idx`` (a pool lookup)."""
        idx = idx.long()
        return EnvState(**{k: getattr(self, k)[idx] for k in self._fields()})


def _num_fixed(assets: Assets) -> int:
    return 1 + assets.suite.scen_states.shape[1]


def max_agents(assets: Assets) -> int:
    return assets.background.bg_states.shape[2]


def _spawn_cell_centers() -> np.ndarray:
    """Jitter-grid cell centers, ordered closest-to-ego first."""
    cell = 2.0 * SPAWN_FOV / SPAWN_GRID
    ii = np.arange(SPAWN_GRID, dtype=np.float32)
    centers = -SPAWN_FOV + cell * (ii + 0.5)
    gx, gy = np.meshgrid(centers, centers, indexing="ij")
    base = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    order = np.argsort(np.hypot(base[:, 0], base[:, 1]), kind="stable")
    return base[order]


_SPAWN_BASE = tuple(map(tuple, _spawn_cell_centers().tolist()))


@dataclasses.dataclass
class ResetDraws:
    """Every random quantity one reset consumes, for n envs."""

    case: torch.Tensor          # (n,) scenario index
    frac: torch.Tensor          # (n,) U(0,1) start point on segment wp0 -> wp1
    speed_u: torch.Tensor       # (n,) U(0,1) start speed / 10
    head_n: torch.Tensor        # (n,) N(0,1) heading noise / 0.1
    attr_u: torch.Tensor        # (n, 3) U(0,1) ego-only length/width/lr
    bg_file: torch.Tensor       # (n,) background file, uniform over valid
    phase_u: torch.Tensor       # (n,) U(0,1) light phase / period
    spawn_jitter: torch.Tensor  # (n, 64, 2) U(-11, 11)
    spawn_psi_n: torch.Tensor   # (n, 64) N(0,1) heading noise / 0.05
    spawn_speed: torch.Tensor   # (n, 64) U(2, 8)
    spawn_len: torch.Tensor     # (n, 64) U(4.2, 5.2)
    spawn_wid: torch.Tensor     # (n, 64) U(1.8, 2.1)
    spawn_lr: torch.Tensor      # (n, 64) U(0.9, 1.6)


def sample_reset_draws(n: int, generator: torch.Generator, assets: Assets,
                       cfg: EnvConfig,
                       case: Optional[torch.Tensor] = None) -> ResetDraws:
    """Draw the randomness of n resets from ``generator`` (on the assets'
    device). ``case``: optional fixed (n,) scenario indices."""
    dev = assets.device

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def nrm(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    if case is None:
        n_cases = assets.suite.case_town.shape[0]
        case = torch.randint(0, n_cases, (n,), generator=generator, device=dev)
    town = assets.suite.case_town[case.long()].long()
    probs = assets.background.bg_valid[town].float()
    # a town without a valid background file draws uniformly (multinomial
    # refuses an all-zero row)
    probs = torch.where(probs.sum(-1, keepdim=True) > 0, probs,
                        torch.ones_like(probs))
    bg_file = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return ResetDraws(
        case=case.to(torch.int32),
        frac=u(n), speed_u=u(n), head_n=nrm(n), attr_u=u(n, 3),
        bg_file=bg_file.to(torch.int32), phase_u=u(n),
        spawn_jitter=u(n, N_SPAWN, 2) * (2 * SPAWN_JITTER) - SPAWN_JITTER,
        spawn_psi_n=nrm(n, N_SPAWN),
        spawn_speed=u(n, N_SPAWN) * (8.0 - 2.0) + 2.0,
        spawn_len=u(n, N_SPAWN) * (5.2 - 4.2) + 4.2,
        spawn_wid=u(n, N_SPAWN) * (2.1 - 1.8) + 1.8,
        spawn_lr=u(n, N_SPAWN) * (1.6 - 0.9) + 0.9,
    )


def _norm2(d: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((d * d).sum(dim=-1))


def _spawn_candidates(draws: ResetDraws, maps: MapArrays, town: torch.Tensor,
                      ego_xy: torch.Tensor, fixed_xy: torch.Tensor,
                      fixed_present: torch.Tensor):
    """Local traffic genesis: jittered-grid candidates near the ego, pushed
    onto the road, clear of existing agents. Returns (n, 64, 4) states,
    (n, 64, 3) attrs, (n, 64) speeds, (n, 64) valid, ranked ~closest first."""
    base = device_constant(_SPAWN_BASE, ego_xy.device)
    pos = ego_xy[:, None, :] + base + draws.spawn_jitter

    # project candidates onto the drivable area along the SDF gradient
    for _ in range(2):
        sdf_p = sample_sdf_nearest(maps, town, pos)
        gx, gy = sample_sdf_grad(maps, town, pos)
        g = torch.stack([gx, gy], dim=-1)
        g = g / torch.clamp(_norm2(g), min=1e-3)[..., None]
        need = torch.clamp(SPAWN_SDF_MARGIN + 0.8 - sdf_p, 0.0, SPAWN_PROJECT_MAX)
        pos = pos + need[..., None] * g

    sdf = sample_sdf_nearest(maps, town, pos)
    d_ego = _norm2(pos - ego_xy[:, None, :])
    d_fixed = _norm2(pos[:, :, None, :] - fixed_xy[:, None, :, :])
    d_fixed = torch.where(fixed_present[:, None, :], d_fixed,
                          torch.full_like(d_fixed, float("inf")))
    base_valid = ((sdf > SPAWN_SDF_MARGIN)
                  & (d_ego > SPAWN_MIN_EGO_DIST) & (d_ego < SPAWN_FOV)
                  & (d_fixed.amin(dim=-1) > SPAWN_MIN_AGENT_DIST))
    # candidate-candidate spacing against earlier (closer-to-ego) valid cells
    d_cand = _norm2(pos[:, :, None, :] - pos[:, None, :, :])
    tril = torch.ones(N_SPAWN, N_SPAWN, dtype=torch.bool,
                      device=pos.device).tril(diagonal=-1)
    earlier = tril[None] & base_valid[:, None, :]
    d_prev = torch.where(earlier, d_cand,
                         torch.full_like(d_cand, float("inf"))).amin(dim=-1)
    valid = base_valid & (d_prev > SPAWN_MIN_AGENT_DIST)

    psi = sample_dir_angle(maps, town, pos) + 0.05 * draws.spawn_psi_n
    speed = draws.spawn_speed
    states = torch.cat([pos, psi[..., None], speed[..., None]], dim=-1)
    attrs = torch.stack([draws.spawn_len, draws.spawn_wid, draws.spawn_lr],
                        dim=-1)
    return states, attrs, speed, valid


def reset_from_draws(cfg: EnvConfig, assets: Assets,
                     draws: ResetDraws) -> EnvState:
    """Start n new episodes from their random draws (deterministic)."""
    suite, bg, maps = assets.suite, assets.background, assets.maps
    dev = assets.device
    a_max = max_agents(assets)
    n_fixed = _num_fixed(assets)
    n = draws.case.shape[0]
    f32 = torch.float32

    case = draws.case.long()
    town = suite.case_town[case]
    tw = town.long()
    wps = suite.waypoints[case]
    start_xy = wps[:, 0] + draws.frac[:, None] * (wps[:, 1] - wps[:, 0])
    start_speed = draws.speed_u * 10.0
    heading = sample_dir_angle(maps, town, start_xy) + 0.1 * draws.head_n
    ego_state = torch.cat([start_xy, heading[:, None], start_speed[:, None]],
                          dim=-1)
    bg_file = draws.bg_file.long()

    if cfg.ego_only:
        au = draws.attr_u
        ego_attrs = torch.stack([
            au[:, 0] * (5.5 - 4.8) + 4.8,
            au[:, 1] * (2.2 - 1.8) + 1.8,
            au[:, 2] * (0.97 - 0.82) + 0.82,
        ], dim=-1)
        rest = a_max - 1
        states = torch.cat([ego_state[:, None],
                            torch.zeros(n, rest, 4, device=dev)], dim=1)
        attrs = torch.cat([ego_attrs[:, None],
                           torch.ones(n, rest, 3, device=dev)], dim=1)
        present = torch.cat([torch.ones(n, 1, dtype=torch.bool, device=dev),
                             torch.zeros(n, rest, dtype=torch.bool, device=dev)],
                            dim=1)
        target_speed = torch.zeros(n, a_max, device=dev)
    else:
        # the ego takes the background cache's first agent's attributes
        ego_attrs = bg.bg_attrs[tw, bg_file, 0]
        scen_mask = suite.scen_mask[case]                       # (n, S)
        scen_states = suite.scen_states[case]                   # (n, S, 4)
        fixed_states = torch.cat([ego_state[:, None], scen_states], dim=1)
        fixed_attrs = torch.cat([
            ego_attrs[:, None],
            torch.where(scen_mask[..., None], suite.scen_attrs[case],
                        torch.ones((), device=dev))], dim=1)
        fixed_present = torch.cat([
            torch.ones(n, 1, dtype=torch.bool, device=dev), scen_mask], dim=1)
        fixed_speed = torch.cat([
            torch.zeros(n, 1, device=dev),
            torch.where(scen_mask, scen_states[..., 3],
                        torch.zeros((), device=dev))], dim=1)

        tail_cap = a_max - n_fixed
        if cfg.use_background_traffic:
            bg_states = bg.bg_states[tw, bg_file][:, :tail_cap]
            bg_attrs_f = bg.bg_attrs[tw, bg_file][:, :tail_cap]
            bg_present = bg.bg_mask[tw, bg_file][:, :tail_cap]
            # keep only agents far from the ego
            d = _norm2(bg_states[..., :2] - start_xy[:, None, :])
            bg_present = bg_present & (d > BG_FAR_DIST)
            density = bg.bg_density[tw, bg_file].long()
        else:
            # local genesis fills the whole tail
            bg_states = torch.zeros(n, tail_cap, 4, device=dev)
            bg_attrs_f = torch.ones(n, tail_cap, 3, device=dev)
            bg_present = torch.zeros(n, tail_cap, dtype=torch.bool, device=dev)
            density = torch.zeros(n, dtype=torch.long, device=dev)
        all_xy = torch.cat([fixed_states[..., :2], bg_states[..., :2]], dim=1)
        all_present = torch.cat([fixed_present, bg_present], dim=1)
        sp_states, sp_attrs, sp_speed, sp_valid = _spawn_candidates(
            draws, maps, town, start_xy, all_xy, all_present)
        n_remain = 1 + scen_mask.sum(-1) + bg_present.sum(-1)
        k_needed = torch.maximum(TOTAL_AGENT_TARGET - n_remain, density)
        sp_rank = torch.cumsum(sp_valid, dim=-1) - 1
        sp_present = sp_valid & (sp_rank < k_needed[:, None])

        # pack: background agents keep their tail slot; spawned agents
        # (closest first) fill the gaps. The lookup table has one spare
        # entry (index tail_cap) that takes every write of a candidate that
        # does not spawn, and is never read.
        n_sp = sp_present.shape[1]
        gap = ~bg_present
        gap_rank = torch.cumsum(gap, dim=-1) - 1
        lut = torch.full((n, tail_cap + 1), n_sp, dtype=torch.long, device=dev)
        slot = torch.where(sp_present, torch.clamp(sp_rank, max=tail_cap),
                           torch.full_like(sp_rank, tail_cap))
        lut.scatter_(1, slot, torch.arange(n_sp, device=dev).expand(n, n_sp))
        j_fill = torch.gather(lut, 1, torch.clamp(gap_rank, 0, tail_cap - 1))
        sp_rows = torch.cat([sp_states, sp_attrs, sp_speed[..., None],
                             torch.ones(n, n_sp, 1, device=dev)], dim=-1)
        sp_rows = torch.cat([sp_rows, torch.zeros(n, 1, 9, device=dev)], dim=1)
        fill = torch.gather(sp_rows, 1, j_fill[..., None].expand(-1, -1, 9))
        use_fill = gap & (j_fill < n_sp)
        bgp = bg_present[..., None]
        states = torch.cat([fixed_states,
                            torch.where(bgp, bg_states, fill[..., :4])], dim=1)
        attrs = torch.cat([fixed_attrs,
                           torch.where(bgp, bg_attrs_f, fill[..., 4:7])], dim=1)
        present = torch.cat([fixed_present, bg_present | use_fill], dim=1)
        tail_speed = torch.where(
            bg_present, bg_states[..., 3],
            torch.where(use_fill, fill[..., 7], torch.zeros((), device=dev)))
        target_speed = torch.cat([fixed_speed, tail_speed], dim=1)

    period = maps.light_durations.sum()
    time0 = draws.phase_u * period
    zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
    npc_hidden = (policy_net.init_hidden(n, a_max, dev)
                  if cfg.npc_mode == "policy" else None)
    return EnvState(
        town=town.to(torch.int32), case=case.to(torch.int32),
        agent_states=states.to(f32), agent_attrs=attrs.to(f32),
        present=present, npc_target_speed=target_speed.to(f32),
        step_idx=zeros_i, time0=time0.to(f32),
        target_idx=torch.ones_like(zeros_i), reached_num=zeros_i.clone(),
        npc_hidden=npc_hidden,
    )


def reset(cfg: EnvConfig, assets: Assets, n: int, generator: torch.Generator,
          case: Optional[torch.Tensor] = None) -> EnvState:
    """Start n new episodes with randomness from ``generator``."""
    draws = sample_reset_draws(n, generator, assets, cfg, case)
    return reset_from_draws(cfg, assets, draws)


def step(cfg: EnvConfig, assets: Assets, state: EnvState,
         action: torch.Tensor, npc_params: policy_net.NpcGRU = None,
         ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, torch.Tensor,
                    Dict[str, torch.Tensor]]:
    """One step of every env. action (B, 2) [acceleration, steering], clipped
    to the action space. ``npc_params``: the GRU NPC policy in
    ``npc_mode="policy"``. Returns (next_state,
    reward, terminated, truncated, info), each with a leading B axis."""
    suite, maps = assets.suite, assets.maps
    dt = cfg.simulator.dt
    case = state.case.long()
    last_ego = state.agent_states[:, 0]
    t_now = state.time0 + state.step_idx.to(torch.float32) * dt

    # NPC behavior + ego action
    npc_hidden = state.npc_hidden
    npc_args = (maps, state.town, t_now, state.agent_states, state.agent_attrs,
                state.present, state.npc_target_speed)
    if cfg.npc_mode == "policy":
        if npc_hidden is None:
            raise ValueError("npc_mode='policy' needs a state with npc_hidden "
                             "(one reset in policy mode)")
        if npc_params is None:
            raise ValueError("npc_mode='policy' needs the GRU's weights")
        npc_act, npc_hidden = policy_net.npc_policy_actions(
            npc_params, *npc_args, npc_hidden)
    else:
        npc_act = npc_actions(*npc_args)
    low = device_constant(ACTION_LOW, action.device)
    high = device_constant(ACTION_HIGH, action.device)
    ego_act = torch.clamp(action, min=low, max=high)
    acts = torch.cat([ego_act[:, None], npc_act[:, 1:]], dim=1)

    # kinematic bicycle for the whole population
    new_states = bicycle_step(state.agent_states, acts,
                              lr=state.agent_attrs[..., 2], dt=dt,
                              beta_factor=cfg.simulator.bicycle_beta_factor)
    new_states = torch.where(state.present[..., None], new_states,
                             state.agent_states)

    # log-replay override of the fixed slots (never the ego)
    steps = state.step_idx + 1
    rt = suite.replay_states.shape[2]
    r_idx = torch.clamp(steps, max=rt - 1).long()
    replay_now = suite.replay_states[case, :, r_idx]           # (B, 1+S, 4)
    replay_on = suite.replay_mask[case, :, r_idx].clone()      # (B, 1+S)
    replay_on[:, 0] = False
    n_fixed = replay_now.shape[1]
    new_states = torch.cat([
        torch.where(replay_on[..., None], replay_now, new_states[:, :n_fixed]),
        new_states[:, n_fixed:]], dim=1)

    ego = new_states[:, 0]
    t_new = state.time0 + steps.to(torch.float32) * dt

    # infractions of the exposed agent (the ego)
    sizes = state.agent_attrs[..., :2]
    offroad = compute_offroad(maps, state.town, ego, sizes[:, 0])
    if cfg.simulator.collision_metric == CollisionMetric.discs:
        collision = ego_collision_discs(new_states, sizes, state.present)
    else:
        collision = ego_collision(new_states, sizes, state.present)
    violation = traffic_light_violation(maps, state.town, t_new, last_ego, ego,
                                        sizes[:, 0])

    # waypoint logic + reward
    reached = waypoint_reached(ego[:, :2], suite.waypoints[case],
                               state.target_idx, suite.n_waypoints[case])
    d_moved = _norm2(ego[:, :2] - last_ego[:, :2])
    dist_reward = torch.where(d_moved > cfg.distance_cutoff,
                              float(cfg.distance_bonus), 0.0)
    psi_reward = (1.0 - torch.cos(ego[:, 2] - last_ego[:, 2])) * (-cfg.heading_penalty)
    reach_reward = torch.where(reached, float(cfg.waypoint_bonus), 0.0)
    reward = reach_reward + dist_reward + psi_reward

    reached_i = reached.to(torch.int32)
    target_idx = state.target_idx + reached_i
    reached_num = state.reached_num + reached_i

    truncated = steps >= cfg.max_environment_steps
    if cfg.terminated_at_infraction:
        terminated = (offroad > 0) | (collision > 0) | (violation > 0)
    else:
        terminated = torch.zeros_like(truncated)

    info = dict(
        offroad=offroad,
        collision=collision,
        traffic_light_violation=violation,
        is_success=truncated,
        reached_waypoint_num=reached_num,
        psi_smoothness=torch.abs(exact_div(last_ego[:, 2] - ego[:, 2], 0.1)),
        psi_reward=psi_reward,
        dist_reward=dist_reward,
        speed_smoothness=torch.abs(exact_div(last_ego[:, 3] - ego[:, 3], 0.1)),
    )
    next_state = state.replace(
        agent_states=new_states,
        step_idx=steps.to(torch.int32),
        target_idx=target_idx,
        reached_num=reached_num,
        npc_hidden=npc_hidden,
    )
    return next_state, reward, terminated, truncated, info
