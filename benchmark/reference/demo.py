"""Scripted demonstration driver (the benchmark's reference: a frozen copy
of the port's ``rl/demo.py``).

A competent state-based policy: waypoint tracking with IDM-style braking,
obstacle dodge / swerve, stopline compliance with yellow-window handling.
Off-policy learners seed their replay buffers with its transitions
(``demo_steps`` / ``demo_envs`` of the off-policy train step), so the
critic sees trajectories that reach the 200-step truncation.

It acts on the privileged env state (positions, SDF, light phases), not on
pixels: demonstrations only feed the replay buffer; the learner still
trains its image policy and critics on rendered observations.

Batched over the leading env axis where the JAX code ``vmap``s one env.
"""

from __future__ import annotations

import math

import torch

from .config import EnvConfig
from .arrays import Assets, exact_div, sample_sdf
from .traffic_lights import LightState, light_states_at

_INF = float("inf")


def _wrap(a: torch.Tensor) -> torch.Tensor:
    """Angle -> [-pi, pi) (floor-mod, like ``jnp`` ``%``)."""
    return torch.remainder(a + math.pi, 2 * math.pi) - math.pi


def _first_argmin(x: torch.Tensor) -> torch.Tensor:
    """argmin over the last axis with ``jnp.argmin``'s ties: the first index
    of the minimum, so 0 for a row that is all ``inf``."""
    ids = torch.arange(x.shape[-1], device=x.device)
    at_min = x == x.amin(dim=-1, keepdim=True)
    return torch.where(at_min, ids, x.shape[-1]).amin(dim=-1)


def _pick(x: torch.Tensor, j: torch.Tensor) -> torch.Tensor:
    """x (B, N), j (B,) -> x[b, j[b]]."""
    return torch.gather(x, 1, j[:, None])[:, 0]


def _along(rel: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """rel (B, N, 2) projected on each env's unit vector axis (B, 2)."""
    return rel[..., 0] * axis[:, None, 0] + rel[..., 1] * axis[:, None, 1]


def _masked_min(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, x, _INF).amin(dim=-1)


def make_scripted_driver(cfg: EnvConfig, assets: Assets):
    """Returns fn(state_batch) -> (B, 2) env-box actions [accel, steer]."""
    maps, suite = assets.maps, assets.suite
    green, yellow = int(LightState.GREEN), int(LightState.YELLOW)

    @torch.no_grad()
    def drive(s) -> torch.Tensor:
        ego = s.agent_states[:, 0]
        pos, psi, v = ego[:, :2], ego[:, 2], ego[:, 3]
        case, tw = s.case.long(), s.town.long()
        nw = suite.n_waypoints[case]
        tgt = torch.clamp(torch.minimum(s.target_idx, nw - 1), min=0).long()
        wp = suite.waypoints[case, tgt]
        done_route = s.target_idx >= nw
        # aim half a lane to the stored-coords left of the waypoint (the
        # traffic convention of npc/route_follow.py): the route polyline is
        # the road center and oncoming NPCs hold the other half
        to_wp = wp - pos
        dist = torch.sqrt((to_wp * to_wp).sum(-1))
        perp = (torch.stack([-to_wp[:, 1], to_wp[:, 0]], -1)
                / torch.clamp(dist, min=1e-3)[:, None])
        aim = wp + 1.6 * perp
        bearing = torch.atan2(aim[:, 1] - pos[:, 1], aim[:, 0] - pos[:, 0])
        herr = _wrap(bearing - psi)
        steer = torch.clamp(1.5 * herr, -0.3, 0.3)
        fwd = torch.stack([torch.cos(psi), torch.sin(psi)], -1)
        left = torch.stack([-torch.sin(psi), torch.cos(psi)], -1)
        rel = s.agent_states[:, :, :2] - pos[:, None]
        lon, lat = _along(rel, fwd), _along(rel, left)
        others = s.present & (torch.arange(rel.shape[1], device=rel.device) != 0)
        in_reach = others & (lon > 0.0) & (lon < 40.0)
        ahead = in_reach & (torch.abs(lat) < 3.2)
        lon_m = torch.where(ahead, lon, _INF)
        j = _first_argmin(lon_m)
        lon_j = _pick(lon_m, j)
        has = torch.isfinite(lon_j)
        # hard-brake point: v^2/2 at the 1 m/s^2 cap + ~5 m of car
        # half-lengths + 5 m buffer (center-to-center distance). Any agent
        # in the narrow corridor inside stopping distance blocks: tracking
        # only the nearest-ahead lets a passing car in the wide cone mask a
        # parked one dead ahead behind it.
        stop_d = v * v / 2.0 + 12.0
        # the cone widens with distance (curved-road visibility)
        narrow = in_reach & (torch.abs(lat) < 3.0 + 0.08 * lon)
        block = (narrow & (lon < stop_d[:, None])).any(-1)
        dodge_sign = torch.where(_pick(lat, j) > 0.2, -1.0, 1.0)
        dodge = torch.where(
            has & ~block,
            dodge_sign * torch.clamp(exact_div(40.0 - lon_j, 40.0), 0.0, 1.0)
            * 0.25,
            0.0)
        steer = torch.clamp(steer + dodge, -0.3, 0.3)
        # imminent (cannot stop in time even at full brake): swerve hard
        # away from the nearest blocker while braking
        lon_n = torch.where(narrow, lon, _INF)
        jn = _first_argmin(lon_n)
        lon_jn = _pick(lon_n, jn)
        imminent = (torch.isfinite(lon_jn) & (lon_jn < v * v / 2.0 + 6.0)
                    & (v > 1.5))
        # swerve only onto pavement: at least 2 m of road on the chosen side
        sdf_l = sample_sdf(maps, s.town, pos + 3.0 * left)
        sdf_r = sample_sdf(maps, s.town, pos - 3.0 * left)
        away = torch.where(_pick(lat, jn) > 0.0, -1.0, 1.0)
        away_ok = torch.where(away > 0, sdf_l > 2.0, sdf_r > 2.0)
        other_ok = torch.where(away > 0, sdf_r > 2.0, sdf_l > 2.0)
        sw = torch.where(away_ok, away,
                         torch.where(other_ok, -away, torch.zeros_like(away)))
        steer = torch.where(imminent, 0.3 * sw, steer)
        steer = torch.where(done_route, 0.0, steer)
        # stoplines: slow near any aligned light (green can turn),
        # hard-brake for non-green within stopping distance
        t = s.time0 + s.step_idx.to(torch.float32) * cfg.simulator.dt
        sl_mid = (maps.stop_p0[tw] + maps.stop_p1[tw]) / 2.0
        rel_sl = sl_mid - pos[:, None]
        sl_lon, sl_lat = _along(rel_sl, fwd), _along(rel_sl, left)
        aligned = torch.cos(psi[:, None] - maps.stop_dir[tw]) > 0.2
        base = (maps.light_mask[tw] & aligned & (sl_lon > 0.0)
                & (torch.abs(sl_lat) < 5.0))
        gap = sl_lon - 2.5          # front bumper
        states_l = light_states_at(maps, s.town, t)
        not_green = base & (states_l != green)
        any_gap = _masked_min(base, gap)
        red_gap = _masked_min(not_green, gap)
        yellow_gap = _masked_min(base & (states_l == yellow), gap)
        # approach-speed cap against a light that could turn
        green_cap = torch.clamp(
            torch.sqrt(2.0 * torch.clamp(any_gap - 5.0, min=0.0)), 2.0, 6.0)
        v_tgt = torch.where(torch.isfinite(any_gap) & (any_gap < 45.0),
                            green_cap, 5.0)
        # slow through turns (visibility + lateral-acceleration margin)
        v_tgt = torch.minimum(
            v_tgt, torch.sqrt(3.0 * 6.0 / torch.clamp(torch.abs(herr), min=0.05)))
        v_tgt = torch.where(done_route, 0.0, v_tgt)
        can_stop = red_gap >= v * v / 2.0 + 2.0
        brake_light = torch.isfinite(red_gap) & (red_gap < v * v / 2.0 + 6.0)
        # too close to stop when it flipped yellow: clear the line before
        # red; on a light already red, never punch
        clear_past = ~(narrow & (lon < red_gap[:, None] + 14.0)
                       & (torch.abs(lat) < 2.5)).any(-1)
        g_d, y_d = maps.light_durations[0], maps.light_durations[1]
        period = maps.light_durations.sum()
        phase = torch.remainder(t[:, None] + maps.light_phase[tw], period)
        yrem = torch.minimum(torch.clamp(g_d + y_d - phase, min=0.0), y_d)
        l_idx = _first_argmin(torch.where(not_green, gap, _INF))
        t_cross = (red_gap + 4.0) / torch.clamp(v, min=1.0)
        punch = (torch.isfinite(yellow_gap) & (yellow_gap <= red_gap)
                 & ~can_stop & clear_past
                 & (_pick(yrem, l_idx) > t_cross + 0.2))
        brake_light = brake_light & ~punch
        # brake to a stop, never through it into reverse
        brake_a = torch.clamp(exact_div(-v, 0.1), -1.0, 1.0)
        cruise = torch.clamp(torch.where(v > v_tgt, 2.5, 0.8) * (v_tgt - v),
                             -1.0, 1.0)
        accel = torch.where(
            block, brake_a,
            torch.where(punch, torch.ones_like(v),
                        torch.where(brake_light, brake_a, cruise)))
        return torch.stack([accel, steer], -1)

    return drive
