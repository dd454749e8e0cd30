"""Offline asset compilation: scenario suites, background-traffic caches and
map geometry -> the fixed-shape padded numpy bundles the env loads (port of
``torchdriveenv_tpu/maps/compile.py``).

The host pieces (loading, corridor synthesis with evidence-calibrated
widths, traffic-light synthesis, suite and background packing) are numpy
over small lists, in the JAX package's iteration order: the order decides
the ties of the direction field, the dedup of the segment index and the
light clusters. The grid passes run on a device (``device=None`` is the
GPU): the corridor stamp and the exact distance transforms through
``maps/mapkit.py`` (the CUDA kernels of ``csrc/mapkit.cu`` on the card,
their plain twins on the CPU), the segment index in float64 torch.
``tools/compile_assets.py`` is the CLI.

The drivable area is synthesized from the bundled data itself (route and
replay corridors, agent stubs), since the reference's CARLA road meshes are
not available; the schema accepts real map rasters as well.
"""

from __future__ import annotations

import json
import math
import os
import sys

import numpy as np
import torch

from torchdriveenv_tpu_torch.maps import mapkit
from torchdriveenv_tpu_torch.maps.arrays import resolve_device

TOWNS = ["Town01", "Town02", "Town03", "Town07", "Town10HD"]
GRID = 1024            # pixels per side
SCALE = 0.5            # meters per pixel
MARGIN = 24.0          # meters of padding around content bounds
# Corridor half widths. Waypoint polylines trace the ego's lane center, but
# the reference's drivable surface is the whole road (both directions and
# the shoulder): its offroad test fires only when an agent leaves the paved
# surface. The validation suite requires leaving the lane (ParkedCar and
# Chicken are dodges), so a corridor may reach the full road, lane half
# (1.75) + opposing lane (3.5) + shoulder ~= 6 m. Per-segment half widths
# are calibrated from the traffic evidence the reference ships
# (background-cache poses, scenario agents, replay frames, the other
# routes' centerlines): hw = clip(max lateral evidence + its half width +
# PASS_MARGIN, HW_MIN, WAYPOINT_HALFWIDTH). Roads with opposing or adjacent
# traffic keep 6 m; roads whose only evidence is the ego lane shrink to the
# 4.5 m dodge floor. Every evidence pose stays contained (the margin
# exceeds a footprint's half diagonal; tools/audit_map_fidelity.py checks).
WAYPOINT_HALFWIDTH = 6.0   # max corridor half width (two-way road) (m)
HW_MIN = 4.5               # dodge floor: lane + obstacle-passing clearance (m)
PASS_MARGIN = 2.5          # clearance beyond an evidence pose's center (m)
EVIDENCE_LON_SLACK = 3.0   # longitudinal reach of evidence past segment ends (m)
EVIDENCE_LAT_CAP = 6.5     # evidence farther than this is another road (m)
ENDCAP_EXTENSION = 30.0    # corridor continuation beyond the route end (m)
# the spawn end needs only a short overshoot guard (the ego spawns on
# wp0 -> wp1 heading along the lane and never travels far backwards); a
# full back-extension stamps phantom pavement at T-junction route starts
SPAWN_END_EXTENSION = 10.0
STUB_HALFWIDTH = 4.5       # half width around background-agent heading stubs (m)
STUB_LENGTH = 7.0          # background agent stub extent along heading (m)
MAX_AGENTS = 96        # padded agent capacity (reference keeps scenes <100 agents, gym_env.py:216)
MAX_WAYPOINTS = 20     # training cases have 5..20 waypoints
MAX_SCEN_AGENTS = 4    # validation max is 2 predefined agents
MAX_REPLAY_T = 304     # validation max replay length is 300
MAX_BG_FILES = 20      # Town02/Town03 have 20 cached traffic files
MAX_LIGHTS = 16        # synthesized traffic lights per town
MAX_SEGMENTS = 1536    # padded corridor segments per town (max observed 1031)
SEG_CELL = 32.0        # coarse segment-index cell size (m)
SEG_GRID = int(GRID * SCALE / SEG_CELL)   # 16x16 cells over the town extent
SEG_K = 320            # max segments per coarse cell (max observed 292 at 6 m halfwidth)
SEG_REACH = 80.0       # cell half-diag + obs window half-diag + halfwidth (m)
SEG_F = 8              # fields per segment row: p0x p0y p1x p1y shw2 pad pad pad
LIGHT_GREEN, LIGHT_YELLOW, LIGHT_RED = 10.0, 3.0, 7.0   # cycle durations (s)
STOPLINE_SETBACK = 10.0    # stopline distance before the intersection point (m)
STOPLINE_HALFWIDTH = 4.0   # stopline segment half length (m)


def log(*a):
    print("[compile_assets]", *a, file=sys.stderr)


# ---------------------------------------------------------------------------
# geometry helpers (host-side, numpy)
# ---------------------------------------------------------------------------


def calibrate_widths(arr, evidence):
    """Per-segment corridor halfwidths from traffic evidence (see the
    constants block above). ``arr`` (N, 2) route polyline; ``evidence``
    (M, 3) rows [x, y, footprint_halfwidth]. Returns (N-1,) halfwidths in
    [HW_MIN, WAYPOINT_HALFWIDTH]."""
    n_seg = len(arr) - 1
    hws = np.full(max(n_seg, 0), HW_MIN)
    if n_seg <= 0 or len(evidence) == 0:
        return hws
    E = np.asarray(evidence, np.float64)
    pts, ehw = E[:, :2], E[:, 2]
    for k in range(n_seg):
        p0, p1 = arr[k], arr[k + 1]
        seg = p1 - p0
        L = float(np.hypot(*seg))
        if L < 1e-6:
            continue
        d = seg / L
        rel = pts - p0
        lon = rel @ d
        lat = np.abs(rel @ np.array([-d[1], d[0]]))
        m = ((lon > -EVIDENCE_LON_SLACK) & (lon < L + EVIDENCE_LON_SLACK)
             & (lat < EVIDENCE_LAT_CAP))
        if m.any():
            need = float((lat[m] + ehw[m]).max()) + PASS_MARGIN
            hws[k] = np.clip(need, HW_MIN, WAYPOINT_HALFWIDTH)
    return hws


def simplify_polyline(pts, eps=0.4, return_idx=False):
    """Douglas-Peucker. pts (N, 2) -> the subset keeping max deviation
    <= eps. Compacts the render segment set (corridor coverage changes by
    <= eps, well under the corridor halfwidth); the SDF grid is always
    rasterized from the full-resolution segments. ``return_idx`` also
    returns the kept original indices (to map per-segment widths onto the
    simplified spans)."""
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    if n <= 2:
        return (pts, np.arange(n)) if return_idx else pts
    keep = np.zeros(n, bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 <= i0 + 1:
            continue
        seg = pts[i1] - pts[i0]
        len2 = float(seg @ seg)
        rel = pts[i0 + 1:i1] - pts[i0]
        if len2 < 1e-12:
            d = np.linalg.norm(rel, axis=-1)
        else:
            t = np.clip((rel @ seg) / len2, 0.0, 1.0)
            d = np.linalg.norm(rel - t[:, None] * seg[None], axis=-1)
        k = int(np.argmax(d))
        if d[k] > eps:
            km = i0 + 1 + k
            keep[km] = True
            stack.append((i0, km))
            stack.append((km, i1))
    if return_idx:
        return pts[keep], np.nonzero(keep)[0]
    return pts[keep]


def seg_intersect(a0, a1, b0, b1):
    """Intersection point of segments a0-a1 and b0-b1, or None."""
    r = a1 - a0
    s = b1 - b0
    denom = r[0] * s[1] - r[1] * s[0]
    if abs(denom) < 1e-9:
        return None
    q = b0 - a0
    t = (q[0] * s[1] - q[1] * s[0]) / denom
    u = (q[0] * r[1] - q[1] * r[0]) / denom
    if 0.0 <= t <= 1.0 and 0.0 <= u <= 1.0:
        return a0 + t * r
    return None


# ---------------------------------------------------------------------------
# loading reference data (as data inputs, not code)
# ---------------------------------------------------------------------------


def load_suites(ref):
    """The reference checkout's training and validation waypoint suites
    (``torchdriveenv/data/{training,validation}_cases.yml``)."""
    import yaml

    data_dir = os.path.join(ref, "torchdriveenv", "data")
    suites = {}
    for name, fn in [("train", "training_cases.yml"),
                     ("val", "validation_cases.yml")]:
        with open(os.path.join(data_dir, fn)) as f:
            suites[name] = yaml.safe_load(f)
    return suites


def load_background(ref):
    """The reference checkout's background-traffic caches, per town, in
    file-name order (``torchdriveenv/resources/background_traffic/*.json``)."""
    bg_dir = os.path.join(ref, "torchdriveenv", "resources",
                          "background_traffic")
    per_town = {t: [] for t in TOWNS}
    for fn in sorted(os.listdir(bg_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(bg_dir, fn)) as f:
            j = json.load(f)
        town = j["location"].split(":")[-1]
        per_town[town].append(j)
    return per_town


# ---------------------------------------------------------------------------
# compilation passes
# ---------------------------------------------------------------------------


def town_evidence(suites, background, town):
    """All reference-data poses evidencing drivable pavement in this town:
    rows [x, y, footprint_halfwidth], for ``calibrate_widths``."""
    rows = []
    for suite in suites.values():
        scen_list = suite.get("scenarios") or [None] * len(suite["locations"])
        for loc, wps, cseq, sc in zip(
                suite["locations"], suite["waypoint_suite"],
                suite["car_sequence_suite"], scen_list):
            if loc != town:
                continue
            for x, y in np.asarray(wps, np.float64):
                rows.append((x, y, 0.0))       # lane centerline sample
            for seq in (cseq or {}).values():
                for fr in np.asarray(seq, np.float64):
                    rows.append((fr[0], fr[1], 1.1))
            if sc is not None:
                for st, at in zip(sc["agent_states"],
                                  sc["agent_attributes"]):
                    rows.append((st[0], st[1], at[1] / 2.0))
    for j in background.get(town, []):
        for st, at in zip(j["agent_states"], j["agent_attributes"]):
            rows.append((st["center"]["x"], st["center"]["y"],
                         at["width"] / 2.0))
    return np.asarray(rows, np.float64).reshape(-1, 3)


def town_content(suites, background, town):
    """All polyline segments and agent stubs that evidence drivable area.

    Returns (segments, points, render_segments): ``segments`` (p0, p1,
    halfwidth) at full polyline resolution (rasterized into the SDF grid),
    ``points`` the content bounds' samples, ``render_segments`` the
    Douglas-Peucker-simplified set of the analytic road-render index.
    Route and replay corridors carry evidence-calibrated per-segment
    halfwidths (``calibrate_widths``)."""
    segments = []          # (p0, p1, halfwidth)
    render_segments = []
    points = []
    evidence = town_evidence(suites, background, town)

    def add_polyline(arr, hw=None, start_ext=SPAWN_END_EXTENSION,
                     end_ext=ENDCAP_EXTENSION):
        # Roads continue past a route's endpoints (the reference's surface
        # is the whole road mesh), so the end segments extend outward and
        # the corridor does not end in a cliff where a finished route
        # stops. Extensions inherit the calibrated width of their end
        # segment; the spawn end gets only a short overshoot guard.
        arr = np.asarray(arr, np.float64)
        if len(arr) < 2:
            return
        hws = (calibrate_widths(arr, evidence) if hw is None
               else np.full(len(arr) - 1, float(hw)))
        d0 = arr[0] - arr[1]
        n0 = np.hypot(*d0)
        d1 = arr[-1] - arr[-2]
        n1 = np.hypot(*d1)
        ext, ehws = [], []
        if n0 > 0.2 and start_ext > 0:
            ext.append((arr[0] + start_ext * d0 / n0)[None])
            ehws.append([hws[0]])
        ext.append(arr)
        ehws.append(hws)
        if n1 > 0.2 and end_ext > 0:
            ext.append((arr[-1] + end_ext * d1 / n1)[None])
            ehws.append([hws[-1]])
        arr = np.concatenate(ext, axis=0)
        hws = np.concatenate(ehws)
        # keep the grid's content bounds covering the extensions
        points.extend([arr[0].tolist(), arr[-1].tolist()])
        for k in range(len(arr) - 1):
            if np.hypot(*(arr[k + 1] - arr[k])) > 0.2:
                segments.append((arr[k], arr[k + 1], hws[k]))
        simp, idx = simplify_polyline(arr, return_idx=True)
        for k in range(len(simp) - 1):
            # a simplified span covers original segments idx[k]..idx[k+1]-1;
            # take their max width so containment cannot shrink
            shw = float(hws[idx[k]:idx[k + 1]].max())
            render_segments.append((simp[k], simp[k + 1], shw))

    for suite in suites.values():
        for loc, wps, cseq in zip(
            suite["locations"], suite["waypoint_suite"],
            suite["car_sequence_suite"]
        ):
            if loc != town:
                continue
            wps = np.asarray(wps, np.float64)
            points.extend(wps.tolist())
            add_polyline(wps)
            for seq in (cseq or {}).values():
                arr = np.asarray(seq, np.float64)
                points.extend(arr[:, :2].tolist())
                add_polyline(arr[:, :2], start_ext=ENDCAP_EXTENSION)
    # scenario agent stubs (per case town)
    for suite in suites.values():
        scen = suite.get("scenarios")
        if not scen:
            continue
        for loc, sc in zip(suite["locations"], scen):
            if loc != town or sc is None:
                continue
            for x, y, psi, _spd in sc["agent_states"]:
                d = np.array([math.cos(psi), math.sin(psi)])
                c = np.array([x, y])
                stub = (c - STUB_LENGTH * d, c + STUB_LENGTH * d,
                        STUB_HALFWIDTH)
                segments.append(stub)
                render_segments.append(stub)
                points.append([x, y])
    for j in background.get(town, []):
        for st in j["agent_states"]:
            x, y = st["center"]["x"], st["center"]["y"]
            psi = st["orientation"]
            d = np.array([math.cos(psi), math.sin(psi)])
            c = np.array([x, y])
            stub = (c - STUB_LENGTH * d, c + STUB_LENGTH * d, STUB_HALFWIDTH)
            segments.append(stub)
            render_segments.append(stub)
            points.append([x, y])
    return segments, np.asarray(points, np.float64), render_segments


def grid_origin(points):
    """World coordinates (float64) of the town grid's pixel (0, 0) corner:
    the grid centered on the content bounds (``points``) padded by
    MARGIN. ``GRID`` is read at call time."""
    lo = points.min(axis=0) - MARGIN
    hi = points.max(axis=0) + MARGIN
    center = (lo + hi) / 2.0
    extent = GRID * SCALE
    if np.any(hi - lo > extent):
        log(f"WARNING: content extent {hi - lo} exceeds grid extent {extent}")
    return center - extent / 2.0


def segment_arrays(segments):
    """(p0 (n, 2), p1 (n, 2), halfwidth (n,)) float64 of (p0, p1, hw)
    segments."""
    p0 = np.asarray([s[0] for s in segments], np.float64).reshape(-1, 2)
    p1 = np.asarray([s[1] for s in segments], np.float64).reshape(-1, 2)
    hw = np.asarray([s[2] for s in segments], np.float64)
    return p0, p1, hw


def compile_town_map(segments, points, device=None):
    """The town's grid: (origin (2,) float32 numpy, sdf (GRID, GRID)
    float32, dir (GRID, GRID) float32), the grids as tensors on ``device``
    (default: the GPU). The corridor stamp, then the SDF (meters, + inside)
    and the direction of the nearest covered pixel, through
    ``maps/mapkit.py``. ``GRID`` is read at call time."""
    dev = resolve_device(device)
    origin = grid_origin(points)
    drivable = torch.zeros((GRID, GRID), dtype=torch.uint8, device=dev)
    dir_best_d = torch.full((GRID, GRID), 1e9, dtype=torch.float32,
                            device=dev)
    dir_angle = torch.zeros((GRID, GRID), dtype=torch.float32, device=dev)
    mapkit.stamp_segments(GRID, origin, SCALE, *segment_arrays(segments),
                          drivable, dir_best_d, dir_angle)
    sdf = mapkit.sdf(drivable, SCALE)
    dir_full = mapkit.propagate_dir(dir_best_d < 1e8, dir_angle)
    return origin.astype(np.float32), sdf, dir_full


def _dedup_segments(segments):
    """Drop near-identical segments (background stubs repeat the same lanes
    across the ~20 cached traffic files). Stubs (by their fixed length and
    halfwidth) get a coarser 4 m / 30 deg bin: their corridors are wide, so
    merged stubs still cover the same pavement."""
    seen, uniq = set(), []
    for s in segments:
        p0, p1, hw = np.asarray(s[0]), np.asarray(s[1]), s[2]
        is_stub = abs(hw - STUB_HALFWIDTH) < 1e-6 and \
            abs(np.hypot(*(p1 - p0)) - 2 * STUB_LENGTH) < 1e-3
        if is_stub:
            mid = (p0 + p1) / 2.0
            ang = math.atan2(*(p1 - p0)[::-1]) % math.pi   # undirected
            key = ("stub", round(mid[0] / 4), round(mid[1] / 4),
                   round(ang / math.radians(30)))
            if key in seen:
                continue
            seen.add(key)
        else:
            a = (round(p0[0] / 2), round(p0[1] / 2),
                 round(p1[0] / 2), round(p1[1] / 2), round(hw, 1))
            b = (a[2], a[3], a[0], a[1], a[4])
            if a in seen or b in seen:
                continue
            seen.add(a)
        uniq.append(s)
    return uniq


def compile_segment_index(segments, origin, device=None):
    """Corridor segments and a coarse per-cell segment-data index for the
    analytic road render (``ops/rasterizer_cuda.py``): every pixel is tested
    against the corridor segments of the ego's cell.

    Returns (dict, k_max) with, as tensors on ``device`` (default: the GPU):
      seg_data (SEG_GRID, SEG_GRID, SEG_K, SEG_F) float32: for every coarse
        cell, the segments whose corridor can reach an observation window
        centered anywhere in the cell, nearest to the cell center first
        (a stable sort), rows [p0x, p0y, p1x, p1y, shw2, 0, 0, 0] with
        shw2 = hw^2 (-1 sentinel rows never cover a pixel);
      seg_cell_n (SEG_GRID, SEG_GRID) int32 counts.
    The distances are float64 in numpy's dtypes and operation order
    (float32 endpoints, ``sqrt(dx*dx + dy*dy)``), so the index equals the
    JAX package's bit for bit.
    """
    dev = resolve_device(device)
    segments = _dedup_segments(segments)
    n = len(segments)
    f32 = torch.float32

    def col(k):
        a = np.asarray([s[k] for s in segments], np.float32)
        return torch.from_numpy(a).to(dev)

    p0, p1 = col(0).reshape(n, 2), col(1).reshape(n, 2)
    hw = col(2).reshape(n)
    org = torch.as_tensor(np.asarray(origin, np.float64), device=dev)
    ij = torch.stack(torch.meshgrid(
        torch.arange(SEG_GRID, dtype=torch.float64, device=dev),
        torch.arange(SEG_GRID, dtype=torch.float64, device=dev),
        indexing="ij"), -1).reshape(-1, 2)
    cc = org[None, :] + SEG_CELL * (ij + 0.5)             # (cells, 2) f64
    seg = p1 - p0                                         # f32
    len2 = torch.clamp((seg * seg).sum(-1), min=1e-9)     # f32
    rel = cc[:, None, :] - p0[None].double()              # (cells, n, 2)
    t = torch.clamp((rel * seg[None].double()).sum(-1) / len2.double(),
                    0.0, 1.0)
    proj = p0[None].double() + t[..., None] * seg[None].double()
    diff = cc[:, None, :] - proj
    sq = diff * diff
    d = mapkit.ieee_sqrt(sq[..., 0] + sq[..., 1])         # (cells, n)

    reach = (SEG_REACH + hw).double()                      # f32 sum, widened
    near = d < reach[None]
    key = torch.where(near, d, torch.full_like(d, math.inf))
    order = torch.sort(key, dim=1, stable=True).indices
    counts = near.sum(1)
    truncated = int(torch.clamp(counts - SEG_K, min=0).sum())
    counts = torch.clamp(counts, max=SEG_K)
    k = min(SEG_K, n)
    take = order[:, :k]                                    # (cells, k)
    valid = (torch.arange(k, device=dev)[None] < counts[:, None])
    rows = torch.cat([p0[take], p1[take], (hw * hw)[take][..., None]], -1)
    data = torch.zeros((SEG_GRID * SEG_GRID, SEG_K, SEG_F), dtype=f32,
                       device=dev)
    data[:, :, 4] = -1.0                                   # sentinel shw2
    data[:, :k, :5] = torch.where(valid[..., None], rows, data[:, :k, :5])
    counts = counts.to(torch.int32)
    if truncated:
        log(f"WARNING: seg index truncated {truncated} segment entries")
    return dict(
        seg_data=data.reshape(SEG_GRID, SEG_GRID, SEG_K, SEG_F),
        seg_cell_n=counts.reshape(SEG_GRID, SEG_GRID),
    ), int(counts.max())


def synthesize_lights(suites, town):
    """Place traffic lights at corridor crossings: intersections between
    waypoint segments of different cases meeting at > 45 deg, and sharp
    turns inside a route, clustered."""
    segs = []
    for suite in suites.values():
        for ci, (loc, wps) in enumerate(zip(suite["locations"],
                                            suite["waypoint_suite"])):
            if loc != town:
                continue
            wps = np.asarray(wps, np.float64)
            for k in range(len(wps) - 1):
                segs.append((id(suite) * 1000 + ci, wps[k], wps[k + 1]))
    hits = []
    for i in range(len(segs)):
        for j in range(i + 1, len(segs)):
            ci, a0, a1 = segs[i]
            cj, b0, b1 = segs[j]
            if ci == cj:
                continue
            da = a1 - a0
            db = b1 - b0
            na, nb = np.hypot(*da), np.hypot(*db)
            if na < 1e-6 or nb < 1e-6:
                continue
            cosang = abs(np.dot(da, db) / (na * nb))
            if cosang > math.cos(math.radians(45)):
                continue
            p = seg_intersect(a0, a1, b0, b1)
            if p is not None:
                hits.append((p, math.atan2(da[1], da[0]),
                             math.atan2(db[1], db[0])))
    # second source of intersection evidence: sharp turns inside a route
    # (a > 40 deg heading change at an interior waypoint marks a junction)
    for suite in suites.values():
        for loc, wps in zip(suite["locations"], suite["waypoint_suite"]):
            if loc != town:
                continue
            wps = np.asarray(wps, np.float64)
            for k in range(1, len(wps) - 1):
                din = wps[k] - wps[k - 1]
                dout = wps[k + 1] - wps[k]
                if np.hypot(*din) < 1e-6 or np.hypot(*dout) < 1e-6:
                    continue
                a_in = math.atan2(din[1], din[0])
                a_out = math.atan2(dout[1], dout[0])
                turn = (a_out - a_in + math.pi) % (2 * math.pi) - math.pi
                if abs(turn) > math.radians(40):
                    hits.append((wps[k], a_in, a_out))
    # cluster intersection points within 15 m
    clusters = []
    for p, ang_a, ang_b in hits:
        for c in clusters:
            if np.hypot(*(p - c["p"])) < 15.0:
                c["angles"].update(
                    {round(ang_a / (math.pi / 2)) % 4,
                     round(ang_b / (math.pi / 2)) % 4})
                break
        else:
            clusters.append({"p": p, "angles": {
                round(ang_a / (math.pi / 2)) % 4,
                round(ang_b / (math.pi / 2)) % 4}, "raw": (ang_a, ang_b)})
    # spawn-safe zone: the ego spawns uniformly on each case's wp0 -> wp1
    # segment (reference gym_env.py:357) at up to 10 m/s; a stopline on or
    # near a spawn segment forces violations at episode start
    spawn_segs = []
    for suite in suites.values():
        for loc, wps in zip(suite["locations"], suite["waypoint_suite"]):
            if loc == town and len(wps) >= 2:
                spawn_segs.append((np.asarray(wps[0], np.float64),
                                   np.asarray(wps[1], np.float64)))

    def near_spawn(p, margin=18.0):
        for a0, a1 in spawn_segs:
            seg = a1 - a0
            len2 = float(seg @ seg)
            t = np.clip(((p - a0) @ seg) / max(len2, 1e-9), 0.0, 1.0)
            if np.hypot(*(p - (a0 + t * seg))) < margin:
                return True
        return False

    p0s, p1s, dirs, phases = [], [], [], []
    for c in clusters:
        if len(p0s) >= MAX_LIGHTS:
            break
        ang_a, ang_b = c["raw"]
        for appr_i, appr in enumerate((ang_a, ang_b)):
            if len(p0s) >= MAX_LIGHTS:
                break
            d = np.array([math.cos(appr), math.sin(appr)])
            n = np.array([-d[1], d[0]])
            center = c["p"] - STOPLINE_SETBACK * d
            if near_spawn(center):
                continue
            p0s.append(center - STOPLINE_HALFWIDTH * n)
            p1s.append(center + STOPLINE_HALFWIDTH * n)
            dirs.append(appr)
            # opposing approaches share green; perpendicular ones are offset
            # by half a period
            period = LIGHT_GREEN + LIGHT_YELLOW + LIGHT_RED
            phases.append(0.0 if appr_i == 0 else period / 2.0)
    n = len(p0s)
    out = dict(
        stop_p0=np.zeros((MAX_LIGHTS, 2), np.float32),
        stop_p1=np.zeros((MAX_LIGHTS, 2), np.float32),
        stop_dir=np.zeros((MAX_LIGHTS,), np.float32),
        light_phase=np.zeros((MAX_LIGHTS,), np.float32),
        light_mask=np.zeros((MAX_LIGHTS,), bool),
    )
    if n:
        out["stop_p0"][:n] = np.asarray(p0s, np.float32)
        out["stop_p1"][:n] = np.asarray(p1s, np.float32)
        out["stop_dir"][:n] = np.asarray(dirs, np.float32)
        out["light_phase"][:n] = np.asarray(phases, np.float32)
        out["light_mask"][:n] = True
    return out, n


def compile_suite(suite):
    """Padded per-case arrays (reference schema: gym_env.py:56-68 +
    env_utils.py). ``suite``: a dict with ``locations``, ``waypoint_suite``
    and optional ``scenarios`` / ``car_sequence_suite``."""
    C = len(suite["locations"])
    out = dict(
        case_town=np.zeros((C,), np.int32),
        waypoints=np.zeros((C, MAX_WAYPOINTS, 2), np.float32),
        waypoint_mask=np.zeros((C, MAX_WAYPOINTS), bool),
        n_waypoints=np.zeros((C,), np.int32),
        scen_states=np.zeros((C, MAX_SCEN_AGENTS, 4), np.float32),
        scen_attrs=np.zeros((C, MAX_SCEN_AGENTS, 3), np.float32),
        scen_mask=np.zeros((C, MAX_SCEN_AGENTS), bool),
        replay_states=np.zeros((C, 1 + MAX_SCEN_AGENTS, MAX_REPLAY_T, 4), np.float32),
        replay_mask=np.zeros((C, 1 + MAX_SCEN_AGENTS, MAX_REPLAY_T), bool),
    )
    scen_list = suite.get("scenarios") or [None] * C
    cseq_list = suite.get("car_sequence_suite") or [None] * C
    for c in range(C):
        out["case_town"][c] = TOWNS.index(suite["locations"][c])
        wps = np.asarray(suite["waypoint_suite"][c], np.float32)
        n = len(wps)
        out["waypoints"][c, :n] = wps
        # the reference masks out waypoint 0 as a goal (gym_env.py:256) and
        # starts target indexing at 1 (gym_env.py:325); all waypoints are
        # kept here and the target index starts at 1, the same semantics
        out["waypoint_mask"][c, :n] = True
        out["n_waypoints"][c] = n
        sc = scen_list[c]
        if sc is not None:
            st = np.asarray(sc["agent_states"], np.float32)
            at = np.asarray(sc["agent_attributes"], np.float32)
            k = len(st)
            out["scen_states"][c, :k] = st
            out["scen_attrs"][c, :k] = at
            out["scen_mask"][c, :k] = True
        cs = cseq_list[c]
        if cs:
            for slot, seq in cs.items():
                # merged agent slot: 0 = ego, 1..S = scenario agents
                # (gym_env.py:279)
                slot = int(slot)
                arr = np.asarray(seq, np.float32)
                t = min(len(arr), MAX_REPLAY_T)
                out["replay_states"][c, slot, :t] = arr[:t]
                out["replay_mask"][c, slot, :t] = True
    return out


def compile_background(background):
    """Padded background-traffic caches: (towns, files, agents) arrays of
    each town's first MAX_BG_FILES files and first MAX_AGENTS agents."""
    T = len(TOWNS)
    out = dict(
        bg_states=np.zeros((T, MAX_BG_FILES, MAX_AGENTS, 4), np.float32),
        bg_attrs=np.zeros((T, MAX_BG_FILES, MAX_AGENTS, 3), np.float32),
        bg_mask=np.zeros((T, MAX_BG_FILES, MAX_AGENTS), bool),
        bg_density=np.zeros((T, MAX_BG_FILES), np.int32),
        bg_valid=np.zeros((T, MAX_BG_FILES), bool),
    )
    for ti, town in enumerate(TOWNS):
        for fi, j in enumerate(background.get(town, [])[:MAX_BG_FILES]):
            sts = j["agent_states"]
            ats = j["agent_attributes"]
            n = min(len(sts), MAX_AGENTS)
            for k in range(n):
                s, a = sts[k], ats[k]
                out["bg_states"][ti, fi, k] = [s["center"]["x"], s["center"]["y"],
                                               s["orientation"], s["speed"]]
                out["bg_attrs"][ti, fi, k] = [a["length"], a["width"],
                                              a["rear_axis_offset"]]
            out["bg_mask"][ti, fi, :n] = True
            out["bg_density"][ti, fi] = j["agent_density"]
            # the reference resamples until n_agents + density < 100
            # (gym_env.py:216)
            out["bg_valid"][ti, fi] = (len(sts) + j["agent_density"]) < 100
    return out


def suite_from_bundle(z):
    """The waypoint-suite dict that ``compile_suite`` packs into the bundle
    ``z`` (a mapping of its arrays, e.g. ``np.load`` of
    ``suite_train_v1.npz``): every case's town, waypoints, scenario agents
    and replayed sequences, as lists of the bundle's float32 values. It
    stands in for ``load_suites`` while the reference data is not in the
    repository (the tests and ``chip_smoke.py`` compile from it); once it
    is, this moves into a test helper."""
    raw = dict(locations=[], waypoint_suite=[], car_sequence_suite=[],
               scenarios=[])
    for c in range(z["case_town"].shape[0]):
        raw["locations"].append(TOWNS[int(z["case_town"][c])])
        raw["waypoint_suite"].append(
            z["waypoints"][c, :int(z["n_waypoints"][c])].tolist())
        k = int(z["scen_mask"][c].sum())
        raw["scenarios"].append(dict(
            agent_states=z["scen_states"][c, :k].tolist(),
            agent_attributes=z["scen_attrs"][c, :k].tolist(),
            recurrent_states=None) if k else None)
        seqs = {slot: z["replay_states"][c, slot, :int(m.sum())].tolist()
                for slot, m in enumerate(z["replay_mask"][c]) if m.any()}
        raw["car_sequence_suite"].append(seqs or None)
    return raw


def background_from_bundle(b):
    """The {town: [cache, ...]} dict that ``compile_background`` packs into
    the bundle ``b`` (``np.load`` of ``background_v1.npz``): one cache per
    file slot that holds agents or is valid, in slot order, each a dict
    with the reference's json keys (``location``, ``agent_density``,
    ``agent_states``, ``agent_attributes``). It stands in for
    ``load_background`` while the reference data is not in the repository,
    as ``suite_from_bundle`` does."""
    out = {t: [] for t in TOWNS}
    for ti, town in enumerate(TOWNS):
        for fi in range(b["bg_mask"].shape[1]):
            if not (b["bg_valid"][ti, fi] or b["bg_mask"][ti, fi].any()):
                continue
            n = int(b["bg_mask"][ti, fi].sum())
            states = b["bg_states"][ti, fi, :n].tolist()
            attrs = b["bg_attrs"][ti, fi, :n].tolist()
            out[town].append(dict(
                location=f"carla:{town}",
                agent_density=int(b["bg_density"][ti, fi]),
                agent_states=[dict(center=dict(x=x, y=y), orientation=psi,
                                   speed=v) for x, y, psi, v in states],
                agent_attributes=[dict(length=ln, width=w, rear_axis_offset=r)
                                  for ln, w, r in attrs]))
    return out
