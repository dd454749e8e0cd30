#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (torchdriveenv_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches and carries on):
  1. build   compile every CUDA kernel of the main path from csrc/ (nvcc,
             sm_90a) and print the time and nvcc's register report;
  2. kernels hold each kernel against its plain torch twin on the card, at
             the main path's shapes (4096 train envs after 8 steps) and on
             two edge batches (256 ego-only envs; 256 envs in the cell with
             the most road segments), bit for bit; time kernel and twin;
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
            if "Used" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 2. kernels against their plain versions -----------------------
    assets = load_assets("train")
    maps = assets.maps
    env = BatchedEnv(EnvConfig(), assets, N_ENVS, seed=0)
    state, _ = env.reset()
    act = torch.tensor([[0.3, 0.0]], device="cuda").repeat(N_ENVS, 1)
    for _ in range(8):
        state = env.step(state, act).state

    def prep_of(cfg, st):
        t = st.time0 + st.step_idx.float() * cfg.simulator.dt
        case = st.case.long()
        return rc.prepare_obs_inputs(
            maps, st.town, t, st.agent_states, st.agent_attrs, st.present,
            assets.suite.waypoints[case], st.target_idx,
            assets.suite.n_waypoints[case], fov=cfg.simulator.renderer.obs_fov)

    def compare(label, cfg, st, time_it):
        prep = prep_of(cfg, st)
        kern = rc.render_obs_cuda(maps, st.town, *prep)
        twin = rc.render_obs_torch(maps, st.town, *prep)
        torch.cuda.synchronize()
        bad = int((kern != twin).sum())
        nseg = prep[2]
        q = torch.quantile(nseg.float(), torch.tensor([0.5, 0.9],
                                                      device=nseg.device))
        log(f"[kernels] rasterizer {label}: B={st.town.shape[0]} nseg mean "
            f"{nseg.float().mean():.1f} p50 {q[0]:.0f} p90 {q[1]:.0f} max "
            f"{int(nseg.max())} mismatched bytes {bad} of {kern.numel()}")
        if bad or not torch.equal(kern, twin):
            raise AssertionError(f"rasterizer kernel != twin on {label}")
        if not time_it:
            return None
        k_ms = cuda_ms(lambda: rc.render_obs_cuda(maps, st.town, *prep), 20)
        p_ms = cuda_ms(lambda: rc.render_obs_torch(maps, st.town, *prep), 3)
        bound, bound_by, b_ms, o_ms = rasterizer_bound_ms(maps, st.town,
                                                          *prep[:3])
        log(f"[kernels] rasterizer {label}: kernel {k_ms:.4f} ms, twin "
            f"{p_ms:.4f} ms, bound {bound:.4f} ms (by {bound_by}; bytes "
            f"{b_ms:.4f} ms, operations {o_ms:.4f} ms) [{card}]")
        return dict(max_abs_err=float((kern.int() - twin.int()).abs().max()),
                    ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                    nseg_mean=float(nseg.float().mean()))

    main_cmp = compare("main batch", EnvConfig(), state, time_it=True)

    ego_cfg = EnvConfig(ego_only=True)
    ego_env = BatchedEnv(ego_cfg, assets, 256, seed=1)
    ego_state, _ = ego_env.reset()
    ego_state = ego_env.step(ego_state, act[:256]).state
    compare("ego-only edge batch", ego_cfg, ego_state, time_it=False)

    # 256 envs moved, with their agents, into the cell with the most segments
    flat = int(torch.argmax(maps.seg_cell_n))
    n_cell = maps.seg_cell_n.shape[-1]
    town_m, ci_m, cj_m = flat // (n_cell * n_cell), (flat // n_cell) % n_cell, flat % n_cell
    g = torch.Generator(device="cuda").manual_seed(2)
    sub = state.take(torch.arange(256, device="cuda"))
    corner = maps.origin[town_m] + torch.tensor([ci_m, cj_m], device="cuda") * maps.seg_cell
    ego_xy = corner + torch.rand(256, 2, generator=g, device="cuda") * maps.seg_cell
    shift = ego_xy - sub.agent_states[:, 0, :2]
    moved = sub.agent_states.clone()
    moved[..., :2] += shift[:, None, :]
    moved[:, :, 2] = torch.rand(256, 96, generator=g, device="cuda") * 6.2832
    dense = sub.replace(agent_states=moved,
                        town=torch.full_like(sub.town, town_m))
    compare(f"densest-cell edge batch (nseg {int(maps.seg_cell_n.max())})",
            EnvConfig(), dense, time_it=False)

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
        "plain_ms": main_cmp["plain_ms"],
        "bound_ms": main_cmp["bound_ms"],
        "bound_by": main_cmp["bound_by"],
        "library_ms": None,
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
