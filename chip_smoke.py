#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (torchdriveenv_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches and carries on):
  1. build   compile every CUDA kernel of the main path from csrc/ (nvcc,
             sm_90a) and print the time and nvcc's register report;
  2. kernels hold the rasterizer kernel against its plain torch twin on the
             card, bit for bit, at the main path's shapes (4096 train envs
             after 8 steps) and on five edge batches (256 ego-only envs; 256
             envs in the cell with the most road segments; the main batch
             right-handed without the ego highlight; 256 egos on borders and
             corners of the segment grid and beyond the towns' edges; 256
             envs with every agent and waypoint slot filled and crowded onto
             the ego); hold the full-scan kernel (the first version, kept as
             a yardstick) against the twin too; time both kernels in turns
             and the twin, and print them beside both bounds and the number
             of segments that survive the kernel's culls;
  3. main    drive the port's main path, BatchedEnv.step at 4096 envs with
             the default EnvConfig, with the launch counts set to 0 just
             before and read just after; the kernel must have launched once
             per render. Then 4 steps with with_final_obs=True.
Then it prints one JSON line describing each kernel, the card's name and
power limit, and as the last line {"ok": true, "device": {...}}.
"""

import json
import sys
import time

import torch

# bound constants: NVIDIA H100 SXM data sheet (f32 outside the tensor
# cores, HBM3)
PEAK_F32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# f32 operations of the rasterizer per pixel and segment (the road test:
# 2 sub, 2 mul, add, mul, 2 clamp, 2 mul, 2 sub, 2 mul, add, compare, or)
ROAD_OPS = 17
# f32 operations per pixel outside the road scan: pixel center 14, 8 discs
# x 8, 16 boxes x 17, ego box 14, 4 stoplines x 18, 3 x 6 selects
COMPOSITE_OPS = 14 + 8 * 8 + 16 * 17 + 14 + 4 * 18 + 3 * 6
PIXELS = 64 * 64
N_ENVS = 4096
TIMED_STEPS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` calls (after one warm-up)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rasterizer_bound_ms(maps, town, ci, cj, nseg):
    """Least time for one render of these envs: the larger of the bytes
    over HBM rate and the f32 operations over the f32 rate.
    Returns (ms, "bytes" or "operations", bytes ms, operations ms)."""
    b = town.shape[0]
    ops = ROAD_OPS * PIXELS * int(nseg.long().sum()) + COMPOSITE_OPS * PIXELS * b
    cells = torch.unique(torch.stack([town, ci, cj], 1), dim=0)
    rows = maps.seg_cell_n[cells[:, 0].long(), cells[:, 1].long(),
                           cells[:, 2].long()].long().sum()
    nbytes = (int(rows) * 8 * 4                 # segment rows, read once
              + b * (8 + 16 + 8) * 8 * 4        # env / agent / waypoint blocks
              + b * 4 * 4                       # town, ci, cj, nseg
              + b * 3 * PIXELS)                 # uint8 frames
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES, ops / PEAK_F32_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes > t_ops else "operations",
            t_bytes * 1e3, t_ops * 1e3)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 2
    from torchdriveenv_tpu_torch.bench import card_line, phase_ms
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env.batched import BatchedEnv
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.ops import _build
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build()
    log(f"[build] {len(reports)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "entry function" in line or "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions -----------------------
    assets = load_assets("train")
    maps = assets.maps
    env = BatchedEnv(EnvConfig(), assets, N_ENVS, seed=0)
    state, _ = env.reset()
    act = torch.tensor([[0.3, 0.0]], device="cuda").repeat(N_ENVS, 1)
    for _ in range(8):
        state = env.step(state, act).state

    def prep_of(cfg, st, waypoints=None, n_waypoints=None):
        t = st.time0 + st.step_idx.float() * cfg.simulator.dt
        case = st.case.long()
        if waypoints is None:
            waypoints = assets.suite.waypoints[case]
            n_waypoints = assets.suite.n_waypoints[case]
        return rc.prepare_obs_inputs(
            maps, st.town, t, st.agent_states, st.agent_attrs, st.present,
            waypoints, st.target_idx, n_waypoints,
            fov=cfg.simulator.renderer.obs_fov)

    def compare(label, town, prep, **kw):
        """The culled kernel against the twin on one batch, bit for bit."""
        kern = rc.render_obs_cuda(maps, town, *prep, **kw)
        twin = rc.render_obs_torch(maps, town, *prep, **kw)
        torch.cuda.synchronize()
        bad = int((kern != twin).sum())
        nseg = prep[2]
        q = torch.quantile(nseg.float(), torch.tensor([0.5, 0.9],
                                                      device=nseg.device))
        log(f"[kernels] rasterizer {label}: B={town.shape[0]} nseg mean "
            f"{nseg.float().mean():.1f} p50 {q[0]:.0f} p90 {q[1]:.0f} max "
            f"{int(nseg.max())} agents {(prep[4][..., 6] > 0).sum(1).float().mean():.1f} "
            f"waypoints {(prep[5][..., 2] > 0).sum(1).float().mean():.1f} "
            f"mismatched bytes {bad} of {kern.numel()}")
        if bad or not torch.equal(kern, twin):
            raise AssertionError(f"rasterizer kernel != twin on {label}")
        return kern, twin

    main_prep = prep_of(EnvConfig(), state)
    kern, twin = compare("main batch", state.town, main_prep)
    full = rc._render_obs_cuda_fullscan(maps, state.town, *main_prep)
    torch.cuda.synchronize()
    bad = int((full != twin).sum())
    log(f"[kernels] full-scan kernel main batch: mismatched bytes {bad} of "
        f"{full.numel()}")
    if bad:
        raise AssertionError("full-scan kernel != twin on the main batch")

    # both kernels in turns (new, full, full, new), then the twin
    def t_new():
        return cuda_ms(lambda: rc.render_obs_cuda(maps, state.town, *main_prep),
                       50)

    def t_full():
        return cuda_ms(lambda: rc._render_obs_cuda_fullscan(
            maps, state.town, *main_prep), 20)

    turns = [t_new(), t_full(), t_full(), t_new()]
    k_ms, f_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    p_ms = cuda_ms(lambda: rc.render_obs_torch(maps, state.town, *main_prep), 3)
    _, _, b_ms, o_ms = rasterizer_bound_ms(maps, state.town, *main_prep[:3])
    # The operation count is the full scan's. A kernel that beats it does
    # fewer operations than it counts, so only the bytes still bound it.
    bound, bound_by = (o_ms, "operations") if k_ms >= o_ms else (b_ms, "bytes")
    masks = rc.cull_masks_torch(maps, state.town, *main_prep)
    surv = dict(
        nseg_mean=float(main_prep[2].float().mean()),
        frame_segments_mean=float(masks.frame.sum(1).float().mean()),
        tile_segments_mean=float(masks.seg.sum(2).float().mean()),
        tile_segments_max=int(masks.seg.sum(2).max()),
        tile_agents_mean=float(masks.agent.sum(2).float().mean()),
        tile_waypoints_mean=float(masks.wp.sum(2).float().mean()),
        tile_stoplines_mean=float(masks.stopline.sum(2).float().mean()),
        tile_ego_share=float(masks.ego.float().mean()))
    del masks
    log(f"[kernels] rasterizer main batch: kernel {k_ms:.4f} ms (turns "
        f"{turns[0]:.4f}, {turns[3]:.4f}), full-scan kernel {f_ms:.4f} ms "
        f"(turns {turns[1]:.4f}, {turns[2]:.4f}), twin {p_ms:.4f} ms, bounds: "
        f"bytes {b_ms:.4f} ms, full-scan operations {o_ms:.4f} ms; segments "
        f"per env: listed {surv['nseg_mean']:.1f}, after the frame cull "
        f"{surv['frame_segments_mean']:.1f}, per tile "
        f"{surv['tile_segments_mean']:.2f} (max {surv['tile_segments_max']}); "
        f"per tile: agents {surv['tile_agents_mean']:.2f}, waypoints "
        f"{surv['tile_waypoints_mean']:.2f}, stoplines "
        f"{surv['tile_stoplines_mean']:.3f}, ego {surv['tile_ego_share']:.3f} "
        f"[{card}]")
    main_cmp = dict(max_abs_err=float((kern.int() - twin.int()).abs().max()),
                    ms=k_ms, fullscan_ms=f_ms, plain_ms=p_ms, bound_ms=bound,
                    bound_by=bound_by, bytes_bound_ms=b_ms,
                    fullscan_operations_bound_ms=o_ms, **surv)
    del kern, twin, full

    compare("main batch, right-handed, ego not highlighted", state.town,
            main_prep, left_handed=False, highlight_ego=False)

    ego_cfg = EnvConfig(ego_only=True)
    ego_env = BatchedEnv(ego_cfg, assets, 256, seed=1)
    ego_state, _ = ego_env.reset()
    ego_state = ego_env.step(ego_state, act[:256]).state
    compare("ego-only edge batch", ego_state.town, prep_of(ego_cfg, ego_state))

    g = torch.Generator(device="cuda").manual_seed(2)
    sub = state.take(torch.arange(256, device="cuda"))
    n_cell = maps.seg_cell_n.shape[-1]

    def moved_to(ego_xy, town, spread=None):
        """`sub` with each env's agents shifted so the ego sits at ego_xy
        (or, with `spread`, scattered that far around it), headings redrawn."""
        moved = sub.agent_states.clone()
        if spread is None:
            moved[..., :2] += (ego_xy - sub.agent_states[:, 0, :2])[:, None, :]
        else:
            moved[..., :2] = ego_xy[:, None, :] + (torch.rand(
                256, moved.shape[1], 2, generator=g, device="cuda") - 0.5
            ) * 2 * spread
            moved[:, 0, :2] = ego_xy
        moved[:, :, 2] = torch.rand(256, moved.shape[1], generator=g,
                                    device="cuda") * 6.2832
        return sub.replace(agent_states=moved, town=town.to(sub.town.dtype))

    # 256 envs moved, with their agents, into the cell with the most segments
    flat = int(torch.argmax(maps.seg_cell_n))
    town_m, ci_m, cj_m = flat // (n_cell * n_cell), (flat // n_cell) % n_cell, flat % n_cell
    corner = maps.origin[town_m] + torch.tensor([ci_m, cj_m], device="cuda") * maps.seg_cell
    ego_xy = corner + torch.rand(256, 2, generator=g, device="cuda") * maps.seg_cell
    dense = moved_to(ego_xy, torch.full_like(sub.town, town_m))
    compare(f"densest-cell edge batch (nseg {int(maps.seg_cell_n.max())})",
            dense.town, prep_of(EnvConfig(), dense))

    # 224 egos on borders and corners of the 56 busiest cells, 32 beyond the
    # towns' edges, where the cell index clamps
    busiest = torch.argsort(maps.seg_cell_n.flatten(), descending=True)[:56]
    busiest = busiest.repeat_interleave(4)
    b_town = busiest // (n_cell * n_cell)
    b_cell = torch.stack([(busiest // n_cell) % n_cell, busiest % n_cell], 1)
    offs = torch.tensor([[0.0, 0.0], [1.0, 0.0], [0.0, 0.5], [1.0, 1.0]],
                        device="cuda").repeat(56, 1)
    on_border = maps.origin[b_town] + (b_cell + offs) * maps.seg_cell
    e_town = torch.arange(32, device="cuda") % maps.origin.shape[0]
    side = n_cell * maps.seg_cell
    e_frac = torch.rand(32, 2, generator=g, device="cuda")
    e_frac[0::2, 0] = -5.0 / side            # 5 m outside the low edge
    e_frac[1::2, 1] = 1.0 + 5.0 / side       # 5 m outside the high edge
    outside = maps.origin[e_town] + e_frac * side
    border = moved_to(torch.cat([on_border, outside]),
                      torch.cat([b_town, e_town]))
    border_prep = prep_of(EnvConfig(), border)
    log(f"[kernels] cell-border batch: cells clamped to ci "
        f"{int(border_prep[0].min())}..{int(border_prep[0].max())}, cj "
        f"{int(border_prep[1].min())}..{int(border_prep[1].max())}")
    compare("cell-border and town-edge batch", border.town, border_prep)

    # every agent and waypoint slot filled, all within 20 m of the ego (the
    # frame's centre is a corner of four tiles, so boxes straddle tile borders)
    crowd = moved_to(dense.agent_states[:, 0, :2], dense.town, spread=20.0)
    attrs = crowd.agent_attrs.clone()
    attrs[..., 0] = torch.where(crowd.present, attrs[..., 0], 4.6)
    attrs[..., 1] = torch.where(crowd.present, attrs[..., 1], 1.9)
    crowd = crowd.replace(agent_attrs=attrs,
                          present=torch.ones_like(crowd.present))
    n_wp = assets.suite.waypoints.shape[1]
    crowd_wp = crowd.agent_states[:, :1, :2] + (torch.rand(
        256, n_wp, 2, generator=g, device="cuda") - 0.5) * 30.0
    crowd_prep = prep_of(EnvConfig(), crowd, crowd_wp,
                         torch.full_like(crowd.town, n_wp))
    if not ((crowd_prep[4][..., 6] > 0).all()
            and (crowd_prep[5][..., 2] > 0).all()):
        raise AssertionError("the crowded batch left a slot empty")
    compare("crowded batch (16 boxes, 8 discs on the ego)", crowd.town,
            crowd_prep)
    compare("crowded batch, right-handed", crowd.town, crowd_prep,
            left_handed=False)

    # ---- 3. the main path ----------------------------------------------
    cfg = EnvConfig()
    env = BatchedEnv(cfg, assets, N_ENVS, seed=3)
    state, obs = env.reset()
    for _ in range(4):
        state = env.step(state, act).state
    torch.cuda.synchronize()
    rc.render_obs_cuda.launches = 0
    t0 = time.perf_counter()
    for _ in range(TIMED_STEPS):
        out = env.step(state, act)
        state = out.state
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = rc.render_obs_cuda.launches
    steps_per_s = N_ENVS * TIMED_STEPS / elapsed
    checksum = int(out.obs.sum())
    log(f"[main] {TIMED_STEPS} steps x {N_ENVS} envs in {elapsed:.3f} s: "
        f"{steps_per_s:.1f} env-steps/s, obs checksum {checksum}, "
        f"rasterizer launches {launches} [{card}]")
    if launches != TIMED_STEPS:
        raise AssertionError(f"rasterizer launched {launches} times in "
                             f"{TIMED_STEPS} renders")
    if out.obs.shape != (N_ENVS, 3, 64, 64) or out.obs.dtype != torch.uint8:
        raise AssertionError(f"obs {tuple(out.obs.shape)} {out.obs.dtype}")
    if not torch.isfinite(out.reward).all():
        raise AssertionError("non-finite reward")
    if not torch.isfinite(state.agent_states).all():
        raise AssertionError("non-finite agent state")
    # the frames that came out are the twin's frames of the returned state
    if not torch.equal(out.obs, rc.render_obs_torch(maps, state.town,
                                                    *prep_of(cfg, state))):
        raise AssertionError("main-path obs differ from the twin's render")
    log(f"[main] agents present per env: "
        f"{state.present.float().sum(1).mean():.1f}; "
        f"done this step: {int((out.terminated | out.truncated).sum())}")

    phases = phase_ms(cfg, assets, state, env.generator)
    log("[main] phase ms per step: "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()) + f" [{card}]")

    fenv = BatchedEnv(cfg, assets, N_ENVS, seed=4, with_final_obs=True)
    fstate, _ = fenv.reset()
    torch.cuda.synchronize()
    rc.render_obs_cuda.launches = 0
    for _ in range(4):
        fout = fenv.step(fstate, act)
        fstate = fout.state
    torch.cuda.synchronize()
    f_launches = rc.render_obs_cuda.launches
    log(f"[main] with_final_obs: 4 steps, rasterizer launches {f_launches} "
        "(batch + pool render per step)")
    if f_launches != 8 or fout.final_obs.shape != (N_ENVS, 3, 64, 64):
        raise AssertionError("with_final_obs path did not render as expected")

    print(json.dumps({"kernels": [{
        "name": "rasterizer",
        "route": "cuda",
        "source": "torchdriveenv_tpu_torch/csrc/rasterizer.cu",
        "replaces": "torchdriveenv_tpu/ops/rasterizer_pallas.py:342",
        "launches": launches,
        "max_abs_err": main_cmp["max_abs_err"],
        "ms": main_cmp["ms"],
        "fullscan_ms": main_cmp["fullscan_ms"],
        "plain_ms": main_cmp["plain_ms"],
        "bound_ms": main_cmp["bound_ms"],
        "bound_by": main_cmp["bound_by"],
        "library_ms": None,
        "bytes_bound_ms": main_cmp["bytes_bound_ms"],
        "fullscan_operations_bound_ms": main_cmp["fullscan_operations_bound_ms"],
        "cull": {k: main_cmp[k] for k in (
            "frame_segments_mean", "tile_segments_mean", "tile_segments_max",
            "tile_agents_mean", "tile_waypoints_mean", "tile_stoplines_mean",
            "tile_ego_share")},
    }], "main_path": {"env_steps_per_s": steps_per_s, "timed_steps":
                      TIMED_STEPS, "num_envs": N_ENVS, "obs_checksum": checksum,
                      "phases_ms": phases,
                      "nseg_mean": main_cmp["nseg_mean"]}}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
