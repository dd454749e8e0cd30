"""Map-geometry fidelity audit (port of ``tools/audit_map_fidelity.py``).

The drivable area is synthesized from the reference's own bundled data
(waypoint corridors, replay trajectories, agent spawn stubs). This audit
measures how faithful the synthesis is to every piece of ground truth the
reference ships:

  1. every waypoint of every case lies on the road in the compiled SDF
     (center test; the ego spawns between waypoints 0 and 1);
  2. every scenario-predefined agent pose is fully on the road under the
     env's own corner-based offroad metric (``ops/offroad.py``);
  3. every replay pose over time is on the road for the replayed vehicle's
     footprint;
  4. every background-traffic agent of every cache is on the road;
  5. every waypoint is covered by the analytic road-render segment index
     (``seg_data``), the corridor the rasterizer draws, so the observation
     shows road wherever the reward says there is road.

Besides, the spawn segment wp0 -> wp1 of every case is sampled densely and
checked on the road with the largest ego footprint (5.5 x 2.2 m).

The samplers run on ``--device``; the counting is numpy on the host.

    python -m torchdriveenv_tpu_torch.tools.audit_map_fidelity
        [--json out.json] [--device cpu]

Exit code 0 iff every check has 0 violations.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List, Tuple

import numpy as np
import torch

from torchdriveenv_tpu_torch.maps.arrays import (
    Assets,
    load_assets,
    resolve_device,
    sample_dir_angle,
    sample_sdf,
)
from torchdriveenv_tpu_torch.ops.collision import obb_corners

EGO_MAX_SIZE = np.array([5.5, 2.2], np.float32)  # reference gym_env.py:194-196


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _off(assets: Assets, town, states, sizes) -> np.ndarray:
    """Corner-based offroad depth (``ops/offroad.py`` semantics) of poses
    ``states`` (..., 4) with footprints ``sizes`` (..., 2) in towns
    ``town`` (...), on the assets' device."""
    dev = assets.device

    def dev_copy(x):        # a copy: broadcast views are read-only
        return torch.as_tensor(np.array(x), device=dev)

    corners = obb_corners(dev_copy(states), dev_copy(sizes))
    town = dev_copy(town)
    sdf = sample_sdf(assets.maps, town, corners)            # (..., 4)
    return _host(torch.clamp(-sdf.amin(dim=-1), min=0.0))


def audit_waypoints(assets: Assets, suite_name: str) -> dict:
    s = assets.suite
    mask = _host(s.waypoint_mask)
    towns = s.case_town[:, None].expand(mask.shape)
    sdf = _host(sample_sdf(assets.maps, towns, s.waypoints))
    viol = (sdf <= 0) & mask
    return dict(
        suite=suite_name, n=int(mask.sum()), violations=int(viol.sum()),
        min_sdf_m=float(sdf[mask].min()), mean_sdf_m=float(sdf[mask].mean()),
    )


def audit_spawn_segments(assets: Assets, suite_name: str, k: int = 32) -> dict:
    """The ego spawns uniformly on segment wp0 -> wp1, heading from the
    direction field: the largest ego footprint must stay on the road along
    ``k`` interpolants of every case's spawn segment."""
    s = assets.suite
    wp = _host(s.waypoints)
    t = np.linspace(0.0, 1.0, k, dtype=np.float32)[None, :, None]
    pts = wp[:, None, 0] * (1 - t) + wp[:, None, 1] * t        # (C, k, 2)
    towns = np.broadcast_to(_host(s.case_town)[:, None], pts.shape[:2])
    psi = _host(sample_dir_angle(
        assets.maps, torch.as_tensor(np.array(towns), device=assets.device),
        torch.as_tensor(pts, device=assets.device)))
    states = np.concatenate([pts, psi[..., None],
                             np.zeros_like(psi)[..., None]], -1)
    sizes = np.broadcast_to(EGO_MAX_SIZE, pts.shape[:2] + (2,))
    off = _off(assets, towns, states, sizes)
    return dict(suite=suite_name, n=int(off.size),
                violations=int((off > 0).sum()),
                max_offroad_m=float(off.max()))


def audit_scenario_agents(assets: Assets, suite_name: str) -> dict:
    s = assets.suite
    mask = _host(s.scen_mask)
    if not mask.any():
        return dict(suite=suite_name, n=0, violations=0, max_offroad_m=0.0)
    towns = np.broadcast_to(_host(s.case_town)[:, None], mask.shape)
    off = _off(assets, towns, _host(s.scen_states),
               _host(s.scen_attrs)[..., :2])
    off = np.where(mask, off, 0.0)
    return dict(suite=suite_name, n=int(mask.sum()),
                violations=int(((off > 0) & mask).sum()),
                max_offroad_m=float(off.max()))


def audit_replay_poses(assets: Assets, suite_name: str) -> dict:
    s = assets.suite
    mask = _host(s.replay_mask)                         # (C, 1+S, T)
    if not mask.any():
        return dict(suite=suite_name, n=0, violations=0, max_offroad_m=0.0)
    # slot 0 is the ego replay (the largest ego footprint); slots 1..S use
    # the scenario agents' attrs (merged agent order)
    attrs = _host(s.scen_attrs)[..., :2]                # (C, S, 2)
    c = mask.shape[0]
    sizes = np.concatenate(
        [np.broadcast_to(EGO_MAX_SIZE, (c, 1, 2)), attrs], axis=1)
    # masked-out slots may have zero attrs; give them the ego footprint so a
    # stray unmasked pose is caught rather than trivially passing at size 0
    sizes = np.where(sizes.max(-1, keepdims=True) > 0, sizes, EGO_MAX_SIZE)
    towns = np.broadcast_to(_host(s.case_town)[:, None, None], mask.shape)
    off = _off(assets, towns, _host(s.replay_states),
               np.broadcast_to(sizes[:, :, None], mask.shape + (2,)))
    return dict(suite=suite_name, n=int(mask.sum()),
                violations=int(((off > 0) & mask).sum()),
                max_offroad_m=float(np.where(mask, off, 0.0).max()))


def audit_background(assets: Assets) -> dict:
    b = assets.background
    mask = _host(b.bg_mask)                             # (T, F, A)
    towns = np.broadcast_to(
        np.arange(mask.shape[0], dtype=np.int32)[:, None, None], mask.shape)
    off = _off(assets, towns, _host(b.bg_states), _host(b.bg_attrs)[..., :2])
    off = np.where(mask, off, 0.0)
    return dict(suite="background", n=int(mask.sum()),
                violations=int(((off > 0) & mask).sum()),
                max_offroad_m=float(off.max()))


def audit_render_coverage(assets: Assets, suite_name: str) -> dict:
    """Every waypoint must be drawable by the analytic road-render index:
    some segment stored in the waypoint's coarse cell covers it."""
    m, s = assets.maps, assets.suite
    seg_data = _host(m.seg_data)                       # (T, C, C, K, 8)
    cell = float(_host(m.seg_cell))
    origin = _host(m.origin)
    wp = _host(s.waypoints)
    mask = _host(s.waypoint_mask)
    towns = _host(s.case_town)
    n_cells = seg_data.shape[1]
    viol = 0
    worst = 0.0
    for c in range(wp.shape[0]):
        t = int(towns[c])
        for w in range(wp.shape[1]):
            if not mask[c, w]:
                continue
            p = wp[c, w]
            ij = np.clip(((p - origin[t]) / cell).astype(int), 0, n_cells - 1)
            rows = seg_data[t, ij[0], ij[1]]           # (K, 8)
            p0, p1, shw2 = rows[:, 0:2], rows[:, 2:4], rows[:, 4]
            seg = p1 - p0
            len2 = np.maximum((seg * seg).sum(-1), 1e-9)
            tt = np.clip(((p - p0) * seg).sum(-1) / len2, 0.0, 1.0)
            d2 = ((p - (p0 + tt[:, None] * seg)) ** 2).sum(-1)
            covered = (d2 <= shw2) & (shw2 > 0)
            if not covered.any():
                viol += 1
                worst = max(worst, float(np.sqrt(
                    np.maximum(d2 - np.maximum(shw2, 0.0), 0.0).min())))
    return dict(suite=suite_name, n=int(mask.sum()), violations=viol,
                uncovered_worst_gap_m=worst)


def audit(device=None) -> List[Tuple[str, dict]]:
    """Every check on both suites and the background caches, with the
    samplers on ``device`` (default: the GPU) -> [(check, result)]."""
    dev = resolve_device(device)
    results = []
    for suite_name in ("train", "val"):
        assets = load_assets(suite_name, device=dev)
        results.append(("waypoints_on_road",
                        audit_waypoints(assets, suite_name)))
        results.append(("spawn_segment_on_road",
                        audit_spawn_segments(assets, suite_name)))
        results.append(("scenario_agents_on_road",
                        audit_scenario_agents(assets, suite_name)))
        results.append(("replay_poses_on_road",
                        audit_replay_poses(assets, suite_name)))
        results.append(("render_index_covers_waypoints",
                        audit_render_coverage(assets, suite_name)))
    results.append(("background_agents_on_road", audit_background(assets)))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)

    total_viol = 0
    report = []
    for name, r in audit(args.device):
        total_viol += r["violations"]
        line = {"check": name, **r, "ok": r["violations"] == 0}
        report.append(line)
        print(json.dumps(line))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
    print(f"TOTAL violations: {total_viol}")
    return 0 if total_viol == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
