"""Per-case termination forensics for the validation (or training) suite
(port of ``tools/diagnose_val.py``).

For several probe policies it answers why episodes end, per scenario case:

  sac     a trained checkpoint (deterministic), the object of study; it
          acts on frame stacks rendered by the rasterizer kernel
  idle    zero accel and zero steer: if this collides, NPC traffic runs
          into a stationary ego (an env problem, not a policy problem)
  idm     the NPC route follower driving the ego slot: can a sane lane
          follower survive here (ignoring waypoints)?
  chase   a scripted waypoint chaser (P-control steer to the target, speed
          hold): are the waypoints reachable?
  drive   the competent scripted driver of ``rl/demo.py`` (the JAX tool's
          inline copy is the same policy): the winnability ceiling
  swerve  chase + obstacle dodge + red-light stop

Each episode runs ``core.step`` with no auto-reset (an ended episode steps
on, as the JAX tool's does) and records its first termination cause and a
snapshot at that step (ego pose, SDF depth, nearest-agent gap, current
target index); rows aggregate per (case, probe). Output: a table and JSON.

    python -m torchdriveenv_tpu_torch.tools.diagnose_val --suite val \
        --episodes 16 [--policies idle,idm,chase] [--ckpt models/<run>/model_N]
        [--out diag.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.env.batched import _obs_batched
from torchdriveenv_tpu_torch.maps.arrays import (
    Assets,
    device_constant,
    exact_div,
    load_assets,
    resolve_device,
    sample_sdf,
)
from torchdriveenv_tpu_torch.models.policies import scale_action
from torchdriveenv_tpu_torch.npc.route_follow import light_gaps, npc_actions
from torchdriveenv_tpu_torch.rl.demo import (
    _first_argmin,
    _pick,
    _wrap,
    make_scripted_driver,
)
from torchdriveenv_tpu_torch.rl.rollout import init_stack, update_stack
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

CAUSES = ["offroad", "collision", "light", "truncated", "alive"]
# reference README.md:15-27 validation case names (same YAML order)
VAL_NAMES = ["ThreeWay", "Chicken", "ParkedCar", "Roundabout", "TrafficLights"]
PROBES = ("idle", "idm", "chase", "drive", "swerve", "sac")
INT_FIELDS = ("cause", "step", "reached", "target", "near_slot")
FLOAT_FIELDS = ("x", "y", "speed", "sdf", "gap", "near_relpsi", "near_speed",
                "psi")
_INF = float("inf")


def probe_config() -> EnvConfig:
    """The env the diagnosis runs: full traffic, episodes end at the first
    infraction, the training recipe's distance cutoff."""
    return EnvConfig(ego_only=False, use_background_traffic=True,
                     terminated_at_infraction=True, frame_stack=3,
                     distance_cutoff=0.25)


def _ego_action_fn(cfg: EnvConfig, assets: Assets, kind: str, agent):
    """fn(state, stack) -> (B, 2) env-box actions of probe ``kind``."""
    suite, maps, dt = assets.suite, assets.maps, cfg.simulator.dt

    def target_wp(s):
        return suite.waypoints[s.case.long(), s.target_idx.long()]

    if kind == "sac":
        return lambda s, stack: scale_action(
            agent.select_action(stack, deterministic=True))
    if kind == "idle":
        return lambda s, stack: torch.zeros(
            (s.step_idx.shape[0], 2), device=s.step_idx.device)
    if kind == "idm":
        def idm(s, stack):
            t = s.time0 + s.step_idx.to(torch.float32) * dt
            acts = npc_actions(maps, s.town, t, s.agent_states, s.agent_attrs,
                               s.present, torch.full_like(s.present, 7.0,
                                                          dtype=torch.float32))
            dev = acts.device
            return torch.clamp(acts[:, 0],
                               min=device_constant(core.ACTION_LOW, dev),
                               max=device_constant(core.ACTION_HIGH, dev))
        return idm
    if kind == "chase":
        def chase(s, stack):
            ego = s.agent_states[:, 0]
            wp = target_wp(s)
            bearing = torch.atan2(wp[:, 1] - ego[:, 1], wp[:, 0] - ego[:, 0])
            steer = torch.clamp(2.0 * _wrap(bearing - ego[:, 2]), -0.3, 0.3)
            accel = torch.clamp(0.8 * (6.0 - ego[:, 3]), -1.0, 1.0)
            return torch.stack([accel, steer], -1)
        return chase
    if kind == "drive":
        drive = make_scripted_driver(cfg, assets)
        return lambda s, stack: drive(s)
    if kind == "swerve":
        def swerve(s, stack):
            ego = s.agent_states[:, 0]
            pos, psi, v = ego[:, :2], ego[:, 2], ego[:, 3]
            wp = target_wp(s)
            bearing = torch.atan2(wp[:, 1] - pos[:, 1], wp[:, 0] - pos[:, 0])
            steer = torch.clamp(1.5 * _wrap(bearing - psi), -0.3, 0.3)
            rel = s.agent_states[:, :, :2] - pos[:, None]
            cos, sin = torch.cos(psi)[:, None], torch.sin(psi)[:, None]
            lon = rel[..., 0] * cos + rel[..., 1] * sin
            lat = rel[..., 0] * -sin + rel[..., 1] * cos
            slot = torch.arange(rel.shape[1], device=rel.device)
            ahead = (s.present & (slot != 0) & (lon > 0.0) & (lon < 22.0)
                     & (torch.abs(lat) < 3.2))
            lon_m = torch.where(ahead, lon, _INF)
            j = _first_argmin(lon_m)
            lon_j, lat_j = _pick(lon_m, j), _pick(lat, j)
            has = torch.isfinite(lon_j)
            # dodge laterally away from the obstacle, harder when close
            dodge = torch.where(
                has, -torch.sign(lat_j)
                * torch.clamp(exact_div(22.0 - lon_j, 22.0), 0.0, 1.0) * 0.3,
                0.0)
            steer = torch.clamp(steer + dodge, -0.3, 0.3)
            # brake for red lights (the IDM light gap of the ego)
            t = s.time0 + s.step_idx.to(torch.float32) * dt
            lg = light_gaps(maps, s.town, t, s.agent_states[:, :1],
                            s.agent_attrs[:, :1])[:, 0]
            stop_d = v * v / 2.0 + 4.0
            brake = ((torch.isfinite(lg) & (lg < stop_d))
                     | (has & (lon_j < torch.clamp(stop_d, min=8.0))
                        & (torch.abs(lat_j) < 1.8)))
            accel = torch.where(brake, -1.0,
                                torch.clamp(0.8 * (6.0 - v), -1.0, 1.0))
            return torch.stack([accel, steer], -1)
        return swerve
    raise ValueError(kind)


def _nearest(s):
    """Per env: the gap to the nearest other present agent, its slot, its
    heading relative to the ego's and its speed."""
    ego = s.agent_states[:, 0]
    d = torch.sqrt(((s.agent_states[:, :, :2] - ego[:, None, :2]) ** 2
                    ).sum(-1))
    slot = torch.arange(d.shape[1], device=d.device)
    d = torch.where(s.present & (slot != 0), d, _INF)
    j = _first_argmin(d)
    other = torch.gather(s.agent_states, 1,
                         j[:, None, None].expand(-1, 1, 4))[:, 0]
    return d.amin(-1), j, _wrap(other[:, 2] - ego[:, 2]), other[:, 3]


def make_probe(cfg: EnvConfig, assets: Assets, kind: str, agent=None,
               max_steps: int = 200):
    """-> run(generator, episodes, case) -> per-episode diagnostics, a dict
    of (episodes,) tensors on the assets' device (``INT_FIELDS`` int32,
    ``FLOAT_FIELDS`` f32). ``agent``: a SAC agent with its state, for the
    ``sac`` probe."""
    render = kind == "sac"
    fs = cfg.frame_stack
    ego_action = _ego_action_fn(cfg, assets, kind, agent)

    @torch.no_grad()
    def run(generator: torch.Generator, episodes: int, case: int
            ) -> Dict[str, torch.Tensor]:
        dev = assets.device
        cases = torch.full((episodes,), case, dtype=torch.int32, device=dev)
        state = core.reset(cfg, assets, episodes, generator, case=cases)
        res = cfg.simulator.renderer.obs_res
        obs = (_obs_batched(cfg, assets, state) if render else
               torch.zeros((episodes, 3, res, res), dtype=torch.uint8,
                           device=dev))
        stack = init_stack(obs, fs)
        zi = torch.zeros(episodes, dtype=torch.int32, device=dev)
        snap = {k: zi.clone() for k in INT_FIELDS}
        snap["cause"] += 4                                  # alive
        snap.update({k: torch.zeros(episodes, device=dev)
                     for k in FLOAT_FIELDS})
        alive = torch.ones(episodes, dtype=torch.bool, device=dev)
        for _ in range(max_steps):
            acts = ego_action(state, stack)
            state_n, _, term, trunc, info = core.step(cfg, assets, state,
                                                      acts)
            done = term | trunc
            newly = alive & done
            cause = torch.where(
                info["offroad"] > 0, 0, torch.where(
                    info["collision"] > 0, 1, torch.where(
                        info["traffic_light_violation"] > 0, 2, 3)))
            ego = state_n.agent_states[:, 0]
            gap, near_slot, near_relpsi, near_speed = _nearest(state_n)
            new = dict(
                cause=cause, step=state_n.step_idx,
                reached=info["reached_waypoint_num"], x=ego[:, 0],
                y=ego[:, 1], speed=ego[:, 3],
                sdf=sample_sdf(assets.maps, state_n.town, ego[:, :2]),
                gap=gap, target=state_n.target_idx, near_slot=near_slot,
                near_relpsi=near_relpsi, near_speed=near_speed, psi=ego[:, 2])
            snap = {k: torch.where(newly, new[k].to(v.dtype), v)
                    for k, v in snap.items()}
            if render:
                stack = update_stack(stack, _obs_batched(cfg, assets,
                                                         state_n), done)
            alive = alive & ~done
            state = state_n
        # still alive at the step cap: the waypoints reached so far
        snap["reached"] = torch.where(alive, state.reached_num,
                                      snap["reached"])
        return snap

    return run


def restore_agent(ckpt_path: str, obs_channels: int, device=None):
    """A SAC agent holding a model-only checkpoint of the port."""
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    from torchdriveenv_tpu_torch.rl.train import restore_checkpoint
    dev = resolve_device(device)
    agent = SAC(SACConfig(), obs_channels)
    agent.init(device=dev)
    agent.load_state(restore_checkpoint(ckpt_path, dev))
    return agent


def _row(c: int, suite: str, snap) -> dict:
    """One (case, probe) row of the report from a snapshot on the host."""
    causes = snap["cause"]
    ended = [j for j, c_ in enumerate(causes) if c_ < 3]
    return dict(
        case=c,
        name=VAL_NAMES[c] if suite == "val" and c < 5 else str(c),
        counts={nm: sum(1 for x in causes if x == i)
                for i, nm in enumerate(CAUSES)},
        mean_term_step=(sum(snap["step"][j] for j in ended) / len(ended)
                        if ended else None),
        mean_reached=sum(snap["reached"]) / len(causes),
        detail=[dict(cause=CAUSES[causes[j]],
                     **{k: snap[k][j] for k in INT_FIELDS if k != "cause"},
                     **{k: round(snap[k][j], 2 if k not in ("x", "y") else 1)
                        for k in FLOAT_FIELDS})
                for j in range(len(causes))])


def diagnose(cfg: EnvConfig, assets: Assets, suite: str, policies, episodes:
             int, n_cases: int, seed: int = 0, agent=None,
             max_steps: Optional[int] = None) -> dict:
    """{probe: [row per case]}: every probe over the first ``n_cases`` cases,
    ``episodes`` each; the snapshots are read to the host once, at the end."""
    generator = torch.Generator(device=assets.device).manual_seed(seed)
    snaps = {}
    for kind in policies:
        probe = make_probe(cfg, assets, kind, agent,
                           max_steps=max_steps or cfg.max_environment_steps)
        snaps[kind] = [probe(generator, episodes, c) for c in range(n_cases)]
    host = {kind: [{k: v.cpu().tolist() for k, v in s.items()} for s in rows]
            for kind, rows in snaps.items()}
    return {kind: [_row(c, suite, s) for c, s in enumerate(rows)]
            for kind, rows in host.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--suite", default="val")
    ap.add_argument("--episodes", type=int, default=16)
    ap.add_argument("--cases", type=int, default=None,
                    help="number of cases to probe (default: all)")
    ap.add_argument("--ckpt", default=None,
                    help="a model-only SAC checkpoint of the port (adds the "
                    "sac probe)")
    ap.add_argument("--policies", default="idle,idm,chase")
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)
    set_f32_precision()

    device = resolve_device(args.device)
    cfg = probe_config()
    assets = load_assets(args.suite, device=device)
    n_cases = int(assets.suite.case_town.shape[0])
    if args.cases:
        n_cases = min(n_cases, args.cases)
    policies = args.policies.split(",")
    agent = None
    if args.ckpt:
        agent = restore_agent(args.ckpt, 3 * cfg.frame_stack, device)
        if "sac" not in policies:
            policies.append("sac")

    results = diagnose(cfg, assets, args.suite, policies, args.episodes,
                       n_cases, args.seed, agent)
    for kind, rows in results.items():
        for row in rows:
            c_str = " ".join(f"{nm}={row['counts'][nm]}" for nm in CAUSES)
            print(f"[{kind:6s}] case {row['name']:<13s} {c_str} "
                  f"reached={row['mean_reached']:.1f}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
