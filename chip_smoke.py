#!/usr/bin/env python3
"""The card's correctness gate for the PyTorch / CUDA port
(torchdriveenv_tpu_torch).

It times nothing but the hand-written kernels (phase 2 and [maps], beside
their bounds) and the wall seconds of its own phases and runs: the port's
speed is measured by the benchmark (python3 -m benchmark.run), and its
phases' times by the spans of utils/spans.py.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches and carries on):
  1. build   compile every CUDA kernel of the port from csrc/ (nvcc,
             sm_90a) and print the time and nvcc's register report;
  2. kernels hold the rasterizer kernel against its plain torch twin on the
             card, bit for bit, at the main path's shapes (4096 train envs
             after 8 steps) and on five edge batches (256 ego-only envs; 256
             envs in the cell with the most road segments; the main batch
             right-handed without the ego highlight; 256 egos on borders and
             corners of the segment grid and beyond the towns' edges; 256
             envs with every agent and waypoint slot filled and crowded onto
             the ego); time the kernel and the twin, and print them beside
             both bounds and the number of segments that survive the
             kernel's culls. Then the NPC controller's kernel
             (csrc/npc_gaps.cu) against its twins leader_gaps + light_gaps,
             bit for bit, on the 4096-env batch in route mode (the main
             batch) and in policy mode (8 steps of a policy-mode env); the
             kernel and the twins timed beside its bounds. Then [torso]:
             the torso input kernel (csrc/torso_input.cu) against its twin
             nhwc_input, bit for bit and with its strides, on stacks that
             hold every byte value at (512 | 2048 | 4096, 9, 64, 64), its
             device time and the twin's (torch.profiler) beside the bytes
             bound ([train] counts its launches in every train step);
  2a. parity the card's correctness gate. (a) The JAX package's own outputs
             (torchdriveenv_tpu_torch/assets/jax_reference_v1.npz) replayed
             on the card by utils/reference.py: the 15 golden scripts of 60
             ego-only steps (no env may flip), the resets of 8 traffic envs
             in route, policy and ego-only mode, 10 steps of them in route
             and policy mode (at most 1 flipped env), a pooled reset; floats
             at atol 1e-4 / rtol 1e-5, the GRU's state at 1e-5, ints and
             bools exact. (b) maps.arrays.exact_div on the card equal to the
             CPU for every divisor of the env step, the features, the
             drivers and the CNN input. (c) 4096 train envs through
             make_env_fns, the card rendering through the kernel, against
             the CPU from the same draws (core.sample_reset_draws on the
             CPU): a reset and 10 steps in each NPC mode, one pooled step
             with 1280 envs done; flipped envs counted by the discrete
             quantity that parted first (a flag, or an NPC decision: the
             control-field cell, the fold side, the leader, the stopline),
             at most 1e-3 of the envs in route mode and 2e-3 in policy
             mode; 64 envs' frames a step rendered on the CPU, at most a
             1e-3 share of pixels apart. (d) One update each of SAC (the
             stage-1 recipe at batch 512), PPO, A2C and TD3, f32 with cuDNN
             off, card against CPU from one state (2 CPU warm-up updates
             first) with the same inputs: the CPU tests' Adam tolerance,
             metrics at rtol 1e-4 / atol 1e-5;
  2b. maps  the offline map compiler (maps/compile.py, maps/mapkit.py,
             tools/compile_assets.py). The stamp and EDT kernels of
             csrc/mapkit.cu held against their plain twins on the card, bit
             for bit: each town's corridor segments at 1024 x 1024 (the
             stamp, then the EDTs of its offroad, road and covered pixels)
             and edge grids (empty, all source, one pixel, one source,
             random 1000 x 1000; zero-length, outside and partly outside
             segments, no segments, a one-pixel grid); both timed beside
             their bounds. compile_assets on the card from the compiler's
             inputs rebuilt from the shipped bundles, with the launch counts
             set to 0 just before and read just after (one stamp and three
             EDTs a town); its files against the shipped ones (suites and
             background bit-equal; sdf, sdf_gx, sdf_gy at most a 1e-5 share
             of float16 values apart; dir_angle at most a 1e-4 share over
             0.01 rad; seg_cell_n, light_mask exact; origins and stoplines
             1e-4; every seg_data row within 2e-4 of a row of its cell,
             both ways). One town compiled on the CPU through the twins
             equals the card's. The main batch rendered through the kernel
             with the compiled maps: at most a 1e-3 share of pixels apart
             from the shipped maps' frames.
  3. main    drive the port's main path, BatchedEnv.step at 4096 envs with
             the default EnvConfig: after 4 steps, 32 under torch.profiler,
             in which the kernel must have run once per render (its
             render_obs_kernel events; the step replays CUDA graphs, so the
             host launches it none), then 32 more in which the NPC kernel
             must have run once a step, with no host launch. Then 4 steps
             with with_final_obs=True: the host launches the kernel in the
             first two (the eager step and the capture), the trace of the
             last two holds its four runs.
  4. npc   the GRU NPC policy. (a) The shipped weights on the 4096-env
             policy-mode batch after 8 steps, card (TF32 off) against the
             CPU: atol 1e-5 on actions and hidden state, on the card's own
             features and through the features for every agent whose
             features agree (the others, a share of at most 1e-4, are
             counted). (b) BatchedEnv(EnvConfig(npc_mode="policy")) at 4096
             envs: 32 traced steps with 32 kernel runs and no host launch
             (the rasterizer's, then the NPC kernel's in 32 more), frames
             equal to the twin's, npc_hidden finite,
             non-zero for present NPCs and zero in restarted envs; one step
             with no synchronizing call; 4 steps with with_final_obs, as in
             [main].
  5. gym   render_egocentric (the SDF-grid birdview) on the card against the
             CPU on the main path's 4096 envs at 64 px (at most a 1e-3 share
             of pixels may differ), and one frame at 1024 px / 500 m; the
             adapter's step at B = 1 without gymnasium, 100 steps and 100
             with the video frame; then, where gymnasium imports, one
             validation episode of gym.make("torchdriveenv-torch-v0") with
             video and one without.
  6. learner the SAC learner path. (a) The shipped deliverable actor on the
             4096-env batch's frame stacks, f32 on the card against f32 on
             the CPU (atol 1e-4), then with the default bf16 torso. (b) The
             stage-1 recipe at its real size (128 envs, a 3125-cell ring per
             env = 4.9 GB of frames on the card, batches of 512, 4 env steps
             and 64 updates per train step, 16 demo envs, fixed alpha, BC
             term, frozen actor): 6 train steps, then 2 with the demo phase
             over; then 3 train steps of default SAC from fresh weights.
             (c) The evaluator: the deliverable actor over 25 validation
             episodes of 200 steps, then again under torch.profiler. The
             rasterizer's host launches are counted in each train step and
             in the evaluation: a new step function launches it in its first
             two calls (the eager one and the capture of its CUDA graphs)
             and never after; the kernel's runs are counted in a trace of
             the late train steps (2 per env step) and of the second
             evaluation (1 per step).
  7. train   the training CLI's function (rl/train.py:train) on the card,
             from configs that equal the repo's YAML files (RECIPES below;
             where PyYAML imports, the files themselves are loaded and
             compared) with only total_timesteps, log_dir, checkpoint_dir,
             the callbacks' n_steps and record overridden. PPO at full width
             (examples/env_configs/tpu_scale/ppo_1024.yml: 1024 envs, 32
             steps per rollout, 4 epochs of minibatches of 8192, bf16 torso):
             3 train steps, its model_* and full_latest written, one traced
             train step, then one more train step resumed from full_latest.
             A2C and TD3 from artifacts/{a2c,td3}_short_run.yml (10 envs) for
             about three thousand env steps each; the stage-1 SAC recipe with
             the GRU driving every NPC (artifacts/sac_npcpolicy_run.yml: 128
             envs, a 4.9 GB ring, 64 updates of 512) for 3 train steps, its
             npc_hidden carried. Every train step's rasterizer host launches
             are counted (those of the env step's first two calls, then
             none), and its launches of the torso input kernel (on-policy:
             two an env step, one for the last stack, one a gradient step;
             off-policy, past the warm-up: one an env step, two an update);
             after each run one more train step is traced, in which
             the kernel must run twice per env step; one PPO train step must
             make no synchronizing call.
  8. tools   the user workflow around training, in the deliverable's order
             (TRAINING.md:226-231). tools/bc_pretrain at the deliverable's
             width: 128 envs x 600 scripted steps = 76,800 frame stacks
             (2.83 GB) kept on the card;
             3000 BC steps of 512 with no synchronizing call in a step and
             a falling action-MSE; the warm start written. rl.train.train
             of artifacts/sac_stage1_run.yml with init_model = that file for
             2 train steps (a model_* after each): the starting actor is
             BC's. tools/eval_checkpoints over BC and those model_* files,
             25 validation episodes each. tools/distill_npc at batch 256 for
             1500 steps, loaded back equal, then 4 policy-mode BatchedEnv
             steps driven by it. tools/diagnose_val: the six probes (sac =
             the BC checkpoint) on the 5 validation cases, 16 episodes of 50
             steps (cut from the 200-step horizon). tools/audit_map_fidelity
             on the card, its counts equal to the CPU's.
  9. multi   data parallelism over torch.distributed, its ranks run as
             subprocesses of this script (--multi-worker), each with a
             timeout. World 1 under nccl (torchrun-style variables,
             WORLD_SIZE=1): two train steps of the stage-1 SAC recipe shrunk
             to a 64-cell ring and 4 updates, and one PPO train step of the
             ppo_1024.yml recipe at 256 envs, each equal to the run with no
             process group, with no collective issued. World 2 under gloo,
             both ranks on the one card: a 4096-env route-mode rollout of 8
             steps (2048 envs per rank, through the kernel, one launch per
             step on each rank) against one process (done flags exact,
             states at atol 1e-4 / rtol 1e-5, at most a 1e-3 share of pixels
             apart); a pooled-reset step with 1280 envs done, unevenly split
             between the ranks; one f32 SAC and one PPO train step at 64
             envs with cuDNN off, the parameters equal on both ranks and
             within the CPU tests' Adam tolerance of one process, then one
             more each whose synchronizing calls are counted by source
             line. A one-process witness, cuDNN on and off: a SAC critic
             gradient taken whole and as the sum over the two ranks' rows,
             one Adam step apart. The drift case: two
             gloo ranks on the card and two single processes (cuDNN on, the
             reference; cuDNN off, the yardstick), started together, each
             taking 200 train steps of the stage-1 SAC recipe shrunk to 64
             envs, 256 ring cells and 2 updates of 128, at the port's
             precision: the critic's relative parameter distance and the
             critic and actor losses' relative gaps against the reference
             at steps 1-200; the sharded distance held to DRIFT_BOUND
             times the yardstick's at every mark (the bound PERF.md
             states). The recipe freezes the actor and scripts every env
             for these steps: the case trains the critic on data the
             learner does not steer.
Then it prints one JSON line describing each kernel (its times and
bounds) and what each phase checked, the card's name and power limit, and
as the last line {"ok": true, "device": {...}}.

    python3 chip_smoke.py --cards 4

needs four cards, and fails with fewer. It builds the kernels, then runs
the training CLI's train (rl/train.py) data parallel over the four cards,
each rank a subprocess of this script on its own card (LOCAL_RANK = RANK)
under nccl, every subprocess with a timeout and all killed when one
fails. Stage B, four ranks: PPO from ppo_1024.yml at 4096 envs and at its
own 1024, and the stage-1 SAC recipe (128 envs, a 3125-cell ring), f32
with cuDNN off, 3 train steps each (PPO at 1024 and SAC with full_latest
at train step 2 and at the end, and resumed from the step-2 file for one
train step); then the same recipes at their own precision (PPO at 4096
envs and at 4096 a card, SAC; 3 train steps). Stage C, one process a
card side by side: the same three parity runs as references, the step-2
files resumed in one process, and two witnesses of summation order (the
first updating train step of PPO at 4096 envs and of SAC taken twice from
one state, the second time with each batch's rows in another order).
Stage D: the README's command, python -m
torch.distributed.run --standalone --nproc_per_node 4 -m
torchdriveenv_tpu_torch.rl.train --config_file ppo_1024.yml at 4096 envs
for 3 train steps, its evaluation and video included. Held: the ranks'
agents bit-equal; every world-4 run within the CPU tests' Adam tolerance
of one process after each of its first 3 gradient updates from one state;
after its first updating train step (64 updates, where other summation
orders have compounded past that tolerance), PPO at 4096 envs and SAC
departing from one process at most CARD_WITNESS_ORDER times as far as
their witnesses (the later train steps and the metrics are printed); 2
rasterizer launches per env step on every rank, rendering its own rows
(and the reset pool); model_* and full_latest written by rank 0 alone;
the resume at world 4 bit-equal to the run without a break; the resume in
one process with its step count, generator, env rows and replay ring
equal and its first 3 updates within the Adam tolerance; 2 rasterizer
launches per env step in the recipe-precision runs too. Printed: peak
memory beside the replay ring, rank 0's evaluation gap against nccl's
default timeout; the same last line, whose count is then 4.
"""

import contextlib
import copy
import dataclasses
import importlib
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback
import types
import warnings

import torch

# bound constants: NVIDIA H100 SXM data sheet (f32 outside the tensor
# cores, HBM3)
PEAK_F32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12
N_ENVS = 4096
TRACED_STEPS = 32


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


# ---- the [maps] phase: the offline map compiler -------------------------

# H100 SXM data sheet: float64 outside the tensor cores
PEAK_F64_OPS = 34e12
# float64 operations of the stamp per (pixel, segment) pair inside the
# segment's window: 2 sub, 2 mul, add, div, 2 clamp, 2 mul, 2 sub, 2 mul,
# add, compare, sqrt, narrow, compare
STAMP_OPS = 20
# operations per pixel of a linear-time exact EDT (a lower envelope per
# line in each of the two passes: intersections, pushes, pops, the fill)
EDT_LINEAR_OPS = 40
MAPS_KERNEL_REPS = 20
MAPS_CPU_TOWN = "Town01"     # the town compiled on the CPU too (fewest segments)
MAP_KERNELS = ("stamp_kernel", "edt_columns", "edt_rows")


def kernel_device_us(fn, reps, names=MAP_KERNELS):
    """Mean device time (us) per launch of each kernel whose name holds one
    of `names` (the map kernels unless told) over `reps` calls of fn, from
    torch.profiler's CUDA activity (the kernels alone: uploads and
    allocations are other events); {} where it records none."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total, count = {}, {}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", None)
              or getattr(e, "cuda_time_total", 0))
        for name in names:
            if name in e.key and e.count and us:
                total[name] = total.get(name, 0.0) + us
                count[name] = count.get(name, 0) + e.count
    return {name: total[name] / count[name] for name in total}


def device_ms(us, names):
    """The summed device time (ms) of the kernels `names` of one call, from
    kernel_device_us's result; None where the profiler recorded one not."""
    if not all(n in us for n in names):
        return None
    return sum(us[n] for n in names) / 1e3


def stamp_bounds_ms(grid, win, n):
    """Least time for one stamp: the three grids read and written once
    (1 + 4 + 4 bytes a pixel each way) and the segment table read once,
    against the float64 operations of the (pixel, segment) pairs inside the
    windows. Returns (bytes ms, operations ms, pairs)."""
    area = ((win[:, 2] - win[:, 0]).clip(min=0).astype("int64")
            * (win[:, 3] - win[:, 1]).clip(min=0).astype("int64"))
    pairs = int(area.sum())
    nbytes = 18 * grid * grid + n * (6 * 8 + 5 * 4 + 4)
    return (nbytes / PEAK_HBM_BYTES * 1e3,
            STAMP_OPS * pairs / PEAK_F64_OPS * 1e3, pairs)


def edt_bounds_ms(grid):
    """Least time for one EDT: the uint8 source read once, the float32
    distance and int32 index written once, against a linear-time exact
    transform's operations. Returns (bytes ms, operations ms, the brute
    force's min-plus steps' ms at the f32 rate)."""
    px = grid * grid
    return (9 * px / PEAK_HBM_BYTES * 1e3,
            EDT_LINEAR_OPS * px / PEAK_F32_OPS * 1e3,
            3 * 2 * grid ** 3 / PEAK_F32_OPS * 1e3)


def maps_phase(assets, state, card) -> dict:
    """[maps]: the offline map compiler on the card. (1) The stamp and EDT
    kernels against their twins on the card, bit for bit, on each town's
    corridor segments at 1024 x 1024 (the stamp, then the EDTs of its
    offroad, its road and its covered pixels) and on edge grids; both timed
    beside their bounds. (2) compile_assets on the card from the compiler's
    inputs rebuilt from the shipped bundles, its kernel launches counted
    (a town: one stamp, and three EDTs of two passes each), its files held
    to the shipped ones.
    (3) One town compiled on the CPU through the twins equals the card's.
    (4) The [kernels] main batch rendered through the kernel with the
    compiled maps against the shipped maps' frames."""
    import numpy as np

    import torchdriveenv_tpu_torch
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.maps import compile as mc
    from torchdriveenv_tpu_torch.maps import mapkit as mk
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    from torchdriveenv_tpu_torch.tools import compile_assets as ca

    t_phase = time.perf_counter()
    shipped_dir = torchdriveenv_tpu_torch._data_path[0]

    def shipped(name):
        return np.load(os.path.join(shipped_dir, name))

    suites = {s: mc.suite_from_bundle(shipped(f"suite_{s}_v1.npz"))
              for s in ("train", "val")}
    background = mc.background_from_bundle(shipped("background_v1.npz"))
    g = mc.GRID
    dev = "cuda"
    err = dict(stamp=0.0, edt=0.0)     # kernel against twin, max abs

    def grids(n=g):
        return (torch.zeros((n, n), dtype=torch.uint8, device=dev),
                torch.full((n, n), 1e9, dtype=torch.float32, device=dev),
                torch.zeros((n, n), dtype=torch.float32, device=dev))

    def stamp_pair(n, origin, p0, p1, hw, label):
        """The kernel against the twin run on the CPU, where its arithmetic
        is mapkit.cpp's: torch's CUDA division by a Python scalar multiplies
        by the reciprocal (one bit lost), so the twin run on the card can
        differ where a pixel centre lies exactly on a segment."""
        kern = grids(n)
        ref = tuple(t.cpu() for t in grids(n))
        mk.stamp_segments_cuda(n, origin, mc.SCALE, p0, p1, hw, *kern)
        mk.stamp_segments_torch(n, origin, mc.SCALE, p0, p1, hw, *ref)
        torch.cuda.synchronize()
        for name, a, b in zip(("drivable", "dir_best_d", "dir_angle"), kern,
                              ref):
            a = a.cpu()
            check(torch.equal(a, b), f"[maps] stamp kernel != twin on {label}: "
                  f"{name} differs at {int((a != b).sum())} pixels")
            err["stamp"] = max(err["stamp"],
                               float((a.double() - b.double()).abs().max()))
        return kern

    def edt_pair(src, label):
        kd, ki = mk.edt_cuda(src)
        td, ti = mk.edt_torch(src)
        torch.cuda.synchronize()
        check(torch.equal(kd, td) and torch.equal(ki, ti),
              f"[maps] edt kernel != twin on {label}: distance differs at "
              f"{int((kd != td).sum())}, index at {int((ki != ti).sum())} "
              "pixels")
        err["edt"] = max(err["edt"], float((kd.double() - td.double()).abs()
                                           .max()))
        return kd, ki

    # ---- (1) kernels against twins: the five towns --------------------
    by_town, stamp_ms, stamp_twin_ms, edt_ms, edt_twin_ms = {}, [], [], [], []
    stamp_dev_ms, edt_dev_ms = [], []
    stamp_b, stamp_o, edt_b, edt_o = [], [], [], []
    for town in mc.TOWNS:
        segs, pts, _ = mc.town_content(suites, background, town)
        origin = mc.grid_origin(pts)
        p0, p1, hw = mc.segment_arrays(segs)
        drv, best, ang = stamp_pair(g, origin, p0, p1, hw, town)
        table = mk.segment_table(g, origin, mc.SCALE, p0, p1, hw)
        work = grids()

        def stamp_call():
            mk.stamp_segments_cuda(g, origin, mc.SCALE, p0, p1, hw, *work,
                                   table=table)

        k_ms = cuda_ms(stamp_call, MAPS_KERNEL_REPS)
        dev_us = {"stamp": kernel_device_us(stamp_call, MAPS_KERNEL_REPS)}
        kd_ms = device_ms(dev_us["stamp"], ("stamp_kernel",))
        t_ms = cuda_ms(lambda: mk.stamp_segments_torch(
            g, origin, mc.SCALE, p0, p1, hw, *grids()), 1)
        b_ms, o_ms, pairs = stamp_bounds_ms(g, table[1], len(hw))
        sources = {"offroad": (drv == 0).to(torch.uint8), "road": drv,
                   "covered": (best < 1e8).to(torch.uint8)}
        e_ms, ed_ms, et_ms = {}, {}, {}
        for name, src in sources.items():
            edt_pair(src, f"{town} {name}")
            e_ms[name] = cuda_ms(lambda: mk.edt_cuda(src), MAPS_KERNEL_REPS)
            dev_us[name] = kernel_device_us(lambda: mk.edt_cuda(src),
                                            MAPS_KERNEL_REPS)
            ed_ms[name] = device_ms(dev_us[name], ("edt_columns", "edt_rows"))
            et_ms[name] = cuda_ms(lambda: mk.edt_torch(src), 2)
        eb_ms, eo_ms, brute_ms = edt_bounds_ms(g)
        by_town[town] = dict(
            segments=len(hw), window_pairs=pairs,
            drivable_share=float(drv.float().mean()),
            stamp_ms=k_ms, stamp_device_ms=kd_ms, stamp_twin_ms=t_ms,
            stamp_bytes_bound_ms=b_ms, stamp_operations_bound_ms=o_ms,
            edt_ms=e_ms, edt_device_ms=ed_ms, edt_twin_ms=et_ms,
            device_us=dev_us)
        stamp_ms.append(k_ms), stamp_twin_ms.append(t_ms)
        stamp_dev_ms.append(kd_ms)
        stamp_b.append(b_ms), stamp_o.append(o_ms)
        edt_ms += list(e_ms.values())
        edt_dev_ms += list(ed_ms.values())
        edt_twin_ms += list(et_ms.values())
        edt_b.append(eb_ms), edt_o.append(eo_ms)
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"  # noqa: E731
        log(f"[maps] {town}: {len(hw)} segments, {pairs} (pixel, segment) "
            f"pairs, drivable {by_town[town]['drivable_share']:.4f}; stamp "
            f"{k_ms:.4f} ms a call with its table's packing and upload, "
            f"the kernel's device time {fmt(kd_ms)} ms, twin {t_ms:.1f} ms, "
            f"bounds: bytes {b_ms:.4f} ms, operations {o_ms:.4f} ms; edt "
            + ", ".join(f"{k} {v:.4f}" for k, v in e_ms.items())
            + " ms a call, the two kernels' device time "
            + ", ".join(f"{k} {fmt(v)}" for k, v in ed_ms.items())
            + " ms, twin " + ", ".join(f"{k} {v:.2f}" for k, v in et_ms.items())
            + f" ms, bounds: bytes {eb_ms:.4f} ms, operations {eo_ms:.5f} ms "
            f"(the brute force's steps {brute_ms:.3f} ms); kernel = twin; "
            "device us per launch (torch.profiler): "
            + "; ".join(f"{k} " + ", ".join(f"{n} {v:.1f}" for n, v in d.items())
                        for k, d in dev_us.items())
            + f" [{card}]")
        del drv, best, ang, work, sources

    # ---- (1b) edge grids ------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(5)
    edt_pair(torch.zeros((g, g), dtype=torch.uint8, device=dev), "empty grid")
    edt_pair(torch.ones((g, g), dtype=torch.uint8, device=dev), "all source")
    for n, val in ((1, 1), (1, 0)):
        edt_pair(torch.full((n, n), val, dtype=torch.uint8, device=dev),
                 f"one pixel, source {val}")
    one = torch.zeros((g, g), dtype=torch.uint8, device=dev)
    one[317, 901] = 1
    edt_pair(one, "a single source")
    for p in (0.001, 0.5):
        edt_pair((torch.rand((1000, 1000), generator=gen, device=dev) < p)
                 .to(torch.uint8), f"random 1000 x 1000, p {p}")
    rng = np.random.default_rng(6)
    origin = np.array([-30.0, -30.0])
    p0 = rng.uniform(-60.0, 500.0, (300, 2))
    p1 = p0 + rng.uniform(-30.0, 30.0, (300, 2))
    hw = rng.uniform(1.0, 6.0, 300)
    p1[::7] = p0[::7]                                   # zero length
    p0[1::11] = rng.uniform(-400.0, -100.0, (len(p0[1::11]), 2))  # outside
    p1[1::11] = p0[1::11] + 20.0
    p0[2::13] = rng.uniform(-45.0, -20.0, (len(p0[2::13]), 2))   # partly
    stamp_pair(g, origin, p0, p1, hw, "random segments with zero-length, "
               "outside and partly outside ones")
    stamp_pair(1000, origin, p0, p1, hw, "the same on a 1000 x 1000 grid")
    stamp_pair(g, origin, p0[:0], p1[:0], hw[:0], "no segments")
    stamp_pair(1, np.array([0.0, 0.0]), np.array([[0.1, 0.1]]),
               np.array([[0.4, 0.2]]), np.array([0.5]), "a one-pixel grid")
    # ties: the one above, then the smallest column, must win as the twin's
    ii, jj = torch.meshgrid(torch.arange(g, device=dev),
                            torch.arange(g, device=dev), indexing="ij")
    ties = {
        "a checkerboard": (ii + jj) % 2 == 0,
        "sources on every 3rd column": jj % 3 == 0,
        "sources on every 2nd row": ii % 2 == 0,
        "one diagonal line": ii == jj,
        "two sources equidistant from a band (a row and a column)":
            ((ii == 300) & ((jj == 100) | (jj == 700)))
            | ((jj == 611) & ((ii == 20) | (ii == 980))),
    }
    for label, m in ties.items():
        edt_pair(m.to(torch.uint8), f"1024 x 1024, {label}")
    del ii, jj, ties
    edt_pair((torch.rand((2048, 2048), generator=gen, device=dev) < 0.01)
             .to(torch.uint8), "random 2048 x 2048, p 0.01")
    big = torch.zeros((mk.MAX_EDT_GRID,) * 2, dtype=torch.uint8, device=dev)
    big[-1, -1] = 1
    big_ms = cuda_ms(lambda: mk.edt_cuda(big), 2)
    edt_pair(big, f"{mk.MAX_EDT_GRID} x {mk.MAX_EDT_GRID}, one source in a "
             "corner")
    del big
    torch.cuda.empty_cache()
    p0, p1, hw = mk.one_tile_segments(3000)
    stamp_pair(g, origin, p0, p1, hw, "3000 segments through one tile, "
               "equal distances")
    stamp_pair(1000, origin, p0, p1, hw, "the same on a 1000 x 1000 grid")
    p0, p1, hw = mk.tile_border_segments(rng, 600, g // mk.STAMP_TILE)
    stamp_pair(g, np.array([0.0, 0.0]), p0, p1, hw,
               "windows ending on tile borders")
    log("[maps] kernels = twins on the edge grids (empty, all source, one "
        "pixel, one source, random 1000^2; zero-length and outside segments, "
        "1000^2, none, one pixel; EDT ties: checkerboard, every 3rd column, "
        "every 2nd row, a diagonal, equidistant pairs; random 2048^2; "
        f"{mk.MAX_EDT_GRID}^2 with one source ({big_ms:.3f} ms a transform); "
        "3000 segments through one tile, on 1024^2 and 1000^2; windows on "
        "tile borders)")

    # ---- (2) compile_assets on the card ---------------------------------
    tmp = tempfile.mkdtemp(prefix="tde_maps_")
    try:
        torch.cuda.synchronize()
        mk.stamp_segments_cuda.launches = 0
        mk.edt_cuda.launches = 0
        t0 = time.perf_counter()
        ca.compile_assets(suites, background, tmp, device=dev)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        launches = dict(stamp=mk.stamp_segments_cuda.launches,
                        edt=mk.edt_cuda.launches)
        n_t = len(mc.TOWNS)
        log(f"[maps] compile_assets on the card: {compile_s:.2f} s, "
            f"launches {launches} for {n_t} towns [{card}]")
        check(launches == dict(stamp=n_t, edt=2 * 3 * n_t),
              f"[maps] launches {launches}, want {n_t} stamps and "
              f"{3 * n_t} EDTs of two launches each")
        fidelity = _maps_fidelity(tmp, shipped, mc)

        # ---- (3) one town on the CPU through the twins --------------------
        t0 = time.perf_counter()
        cpu = ca.compile_town(suites, background, MAPS_CPU_TOWN, device="cpu")
        cpu_s = time.perf_counter() - t0
        card_maps = np.load(os.path.join(tmp, "maps_v1.npz"))
        ti = mc.TOWNS.index(MAPS_CPU_TOWN)
        for k, v in cpu.items():
            check(np.array_equal(card_maps[k][ti], v),
                  f"[maps] {MAPS_CPU_TOWN} {k}: the CPU's compile != the card's")
        log(f"[maps] {MAPS_CPU_TOWN} compiled on the CPU (twins) in "
            f"{cpu_s:.2f} s: every array equal to the card's")

        # ---- (4) frames from the compiled maps ----------------------------
        compiled = load_assets("train", device=dev, assets_dir=tmp).maps
        cfg = EnvConfig()
        t = state.time0 + state.step_idx.float() * cfg.simulator.dt
        case = state.case.long()

        def frames(maps):
            prep = rc.prepare_obs_inputs(
                maps, state.town, t, state.agent_states, state.agent_attrs,
                state.present, assets.suite.waypoints[case], state.target_idx,
                assets.suite.n_waypoints[case],
                fov=cfg.simulator.renderer.obs_fov)
            return rc.render_obs_cuda(maps, state.town, *prep)

        new, old = frames(compiled), frames(assets.maps)
        px_share = float((new != old).any(1).float().mean())
        log(f"[maps] the main batch ({state.town.shape[0]} envs) rendered "
            f"with the compiled maps: {px_share:.3g} of the pixels differ "
            "from the shipped maps' frames")
        check(px_share <= 1e-3, f"[maps] {px_share} of the pixels differ")
        del compiled, new, old
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    mean = lambda xs: sum(xs) / len(xs)   # noqa: E731

    def mean_of(xs):
        """The mean of device times, None where one was not measured."""
        return None if None in xs else mean(xs)
    phase_s = time.perf_counter() - t_phase
    log(f"[maps] phase {phase_s:.1f} s")
    return dict(
        towns=by_town, compile_assets_s=compile_s, launches=launches,
        cpu_town=MAPS_CPU_TOWN, cpu_town_s=cpu_s, frames_pixel_share=px_share,
        fidelity=fidelity, phase_s=phase_s,
        max_abs_err=err,
        edt_max_grid_ms=big_ms,
        stamp=dict(ms=mean(stamp_ms), plain_ms=mean(stamp_twin_ms),
                   device_ms=mean_of(stamp_dev_ms),
                   bytes_bound_ms=mean(stamp_b),
                   operations_bound_ms=mean(stamp_o)),
        edt=dict(ms=mean(edt_ms), plain_ms=mean(edt_twin_ms),
                 device_ms=mean_of(edt_dev_ms),
                 bytes_bound_ms=mean(edt_b), operations_bound_ms=mean(edt_o),
                 brute_force_steps_ms=edt_bounds_ms(g)[2]))


def map_kernel_line(maps_path, name) -> dict:
    """The `kernels` entry of a map-compiler kernel: its kernel launches on
    the [maps] path (an EDT is two, its column and row passes) and its
    times and bounds, means over the five towns' inputs (the EDT over its
    three inputs a town; the stamp's time includes its table's packing and
    upload; `device_ms` is the kernels' device time alone, from
    torch.profiler)."""
    k = maps_path[name]
    b, o = k["bytes_bound_ms"], k["operations_bound_ms"]
    return {
        "name": {"stamp": "stamp_segments", "edt": "edt"}[name],
        "route": "cuda",
        "source": "torchdriveenv_tpu_torch/csrc/mapkit.cu",
        "replaces": {"stamp": "csrc/mapkit.cpp:91",
                     "edt": "csrc/mapkit.cpp:146"}[name],
        "launches": maps_path["launches"][name],
        "max_abs_err": maps_path["max_abs_err"][name],
        "ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": max(b, o), "bound_by": "bytes" if b >= o else "operations",
        "library_ms": None,
        "bytes_bound_ms": b, "operations_bound_ms": o,
        "device_ms": k["device_ms"],
        **({"brute_force_steps_ms": k["brute_force_steps_ms"]}
           if name == "edt" else {}),
    }


def _maps_fidelity(out_dir, shipped, mc) -> dict:
    """The compiled bundles against the shipped ones: suites and background
    bit-equal; maps within the stated tolerances (their inputs are the
    bundles' float32 roundings of the reference's float64 data)."""
    import numpy as np

    for fn in ("suite_train_v1.npz", "suite_val_v1.npz", "background_v1.npz"):
        got, want = np.load(os.path.join(out_dir, fn)), shipped(fn)
        check(sorted(got.files) == sorted(want.files), f"[maps] {fn} keys")
        for k in want.files:
            check(got[k].dtype == want[k].dtype
                  and np.array_equal(got[k], want[k]),
                  f"[maps] {fn} {k} differs from the shipped file")
    got, want = np.load(os.path.join(out_dir, "maps_v1.npz")), shipped(
        "maps_v1.npz")
    check(sorted(got.files) == sorted(want.files), "[maps] maps_v1 keys")
    for k in want.files:
        check(got[k].dtype == want[k].dtype and got[k].shape == want[k].shape,
              f"[maps] maps_v1 {k}: {got[k].dtype} {got[k].shape}")
    for k in ("scale", "seg_cell", "light_durations", "town_names",
              "seg_cell_n", "light_mask", "light_phase"):
        check(np.array_equal(got[k], want[k]), f"[maps] maps_v1 {k} differs")
    out = {}
    for k in ("sdf", "sdf_gx", "sdf_gy"):
        out[f"{k}_share"] = float((got[k] != want[k]).mean())
        check(out[k + "_share"] <= 1e-5, f"[maps] {k}: {out[k + '_share']}")
    field, wfield = got["npc_field"], want["npc_field"]
    out["npc_gradient_bytes_share"] = float(((field >> 16) != (wfield >> 16))
                                            .mean())
    check(out["npc_gradient_bytes_share"] <= 1e-5,
          f"[maps] npc_field gradient bytes: {out['npc_gradient_bytes_share']}")

    def wrapped(a, b):
        return np.abs((a - b + np.pi) % (2 * np.pi) - np.pi)

    for k, (a, b) in dict(
            dir_angle=(got["dir_angle"], want["dir_angle"]),
            npc_dir=((field & 0xFFFF).astype(np.uint16).view(np.float16),
                     (wfield & 0xFFFF).astype(np.uint16).view(np.float16))
    ).items():
        diff = wrapped(a.astype(np.float64), b.astype(np.float64))
        out[f"{k}_share_over_0.01"] = float((diff > 0.01).mean())
        out[f"{k}_share_differing"] = float((a != b).mean())
        check(out[f"{k}_share_over_0.01"] <= 1e-4,
              f"[maps] {k}: {out[f'{k}_share_over_0.01']} over 0.01 rad")
    out["origin_max_abs"] = float(np.abs(got["origin"] - want["origin"]).max())
    check(out["origin_max_abs"] <= 1e-4, f"[maps] origin {out['origin_max_abs']}")
    m = want["light_mask"]
    out["stopline_max_abs"] = max(
        float(np.abs(got[k][m] - want[k][m]).max(initial=0.0))
        for k in ("stop_p0", "stop_p1", "stop_dir"))
    check(out["stopline_max_abs"] <= 1e-4,
          f"[maps] stoplines {out['stopline_max_abs']}")
    # seg_data: every listed row of a cell within 2e-4 (max over its five
    # fields) of some row of the same cell in the shipped file, both ways
    worst = 0.0
    n_cells = got["seg_cell_n"].reshape(-1)
    a_all = torch.as_tensor(got["seg_data"][..., :5].reshape(
        -1, mc.SEG_K, 5), device="cuda")
    b_all = torch.as_tensor(want["seg_data"][..., :5].reshape(
        -1, mc.SEG_K, 5), device="cuda")
    for c in range(n_cells.shape[0]):
        n = int(n_cells[c])
        if n == 0:
            continue
        d = (a_all[c, :n, None] - b_all[c, None, :n]).abs().amax(-1)
        worst = max(worst, float(d.amin(1).max()), float(d.amin(0).max()))
    out["seg_data_row_match_max_abs"] = worst
    check(worst <= 2e-4, f"[maps] seg_data rows {worst}")
    log("[maps] compiled against the shipped bundles: suites and background "
        "bit-equal; " + ", ".join(f"{k} {v:.3g}" for k, v in out.items()))
    return out


# The training recipes this script drives, as their YAML files parse
# (tests/test_torch_config.py holds each dict equal to yaml.safe_load of the
# file it is keyed by; PyYAML reads "5e7" and "2e6" as strings).
_ENV = dict(ego_only=False, max_environment_steps=200, frame_stack=3,
            distance_cutoff=0.25, use_background_traffic=True,
            terminated_at_infraction=True)


def _short_run(algorithm: str) -> dict:
    return dict(
        algorithm=algorithm, checkpoint_dir=f"artifacts/{algorithm}_short_ckpt",
        env=dict(_ENV, seed=5),
        eval_train_callback=dict(eval_n_episodes=10, n_steps=10000),
        eval_val_callback=dict(eval_n_episodes=10, n_steps=10000),
        log_dir="artifacts/runs", parallel_env_num=10,
        project="torchdriveenv_tpu", total_timesteps=150000,
        wandb_callback=dict(model_save_freq=50000))


def _stage1_sac(total: str, name: str, **env) -> dict:
    return dict(
        algorithm="sac", parallel_env_num=128, total_timesteps=total,
        project="torchdriveenv_tpu",
        checkpoint_dir=f"artifacts/{name}_ckpt", log_dir="artifacts/runs",
        offpolicy_steps_per_iter=4, offpolicy_updates_per_iter=64,
        demo_envs=16, demo_warmup_steps=100000,
        algo_kwargs=dict(batch_size=512, buffer_size=400000, gamma=0.99,
                         fixed_alpha=0.02, actor_delay_updates=1000000000,
                         bc_coef=50.0),
        env=dict(_ENV, **env),
        eval_train_callback=dict(n_steps=50000, eval_n_episodes=10),
        eval_val_callback=dict(n_steps=50000, eval_n_episodes=25),
        wandb_callback=dict(model_save_freq=100000),
        full_snapshot_every=-1)


RECIPES = {
    "examples/env_configs/tpu_scale/ppo_1024.yml": dict(
        algorithm="ppo", parallel_env_num=1024, total_timesteps="5e7",
        project="torchdriveenv_tpu",
        algo_kwargs=dict(n_steps=32, batch_size=8192, n_epochs=4),
        env=dict(_ENV),
        eval_train_callback=dict(n_steps=1000000, eval_n_episodes=20),
        eval_val_callback=dict(n_steps=1000000, eval_n_episodes=20),
        wandb_callback=dict(model_save_freq=1000000)),
    "artifacts/a2c_short_run.yml": _short_run("a2c"),
    "artifacts/td3_short_run.yml": _short_run("td3"),
    "artifacts/sac_stage1_run.yml": _stage1_sac("2e6", "sac_stage1", seed=29),
    "artifacts/sac_npcpolicy_run.yml": _stage1_sac(
        "1e6", "sac_npcpolicy", seed=31, npc_mode="policy"),
}
PPO_YML = "examples/env_configs/tpu_scale/ppo_1024.yml"
A2C_YML = "artifacts/a2c_short_run.yml"
TD3_YML = "artifacts/td3_short_run.yml"
SAC_YML = "artifacts/sac_stage1_run.yml"
NPC_SAC_YML = "artifacts/sac_npcpolicy_run.yml"

# the [learner] phase's sizes: the stage-1 SAC recipe's
_SAC = RECIPES[SAC_YML]
RECIPE_ENVS = _SAC["parallel_env_num"]
RECIPE_CAPACITY = _SAC["algo_kwargs"]["buffer_size"] // RECIPE_ENVS   # 3125 cells per env
RECIPE_BATCH = _SAC["algo_kwargs"]["batch_size"]
RECIPE_STEPS_PER_ITER = _SAC["offpolicy_steps_per_iter"]
RECIPE_UPDATES_PER_ITER = _SAC["offpolicy_updates_per_iter"]
RECIPE_DEMO_ENVS = _SAC["demo_envs"]
RECIPE_DEMO_STEPS = _SAC["demo_warmup_steps"]
RECIPE_SEED = _SAC["env"]["seed"]
# the [train] phase's depth
PPO_TRAIN_STEPS = 3
A2C_TRAIN_STEPS = 12
TD3_TRAIN_STEPS = 40
NPC_SAC_TRAIN_STEPS = 3
EVAL_EPISODES = 25
EVAL_STEPS = 200


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def learner_phase(assets, env, state, act, card) -> dict:
    """Phase 6: the SAC learner path on the card. ``env`` / ``state`` are the
    main path's 4096-env batch, ``act`` its constant action."""
    from torchdriveenv_tpu_torch.config import EnvConfig, construct_rl_training_config
    from torchdriveenv_tpu_torch.env.batched import make_env_fns
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.models import load_actor
    from torchdriveenv_tpu_torch.models.policies import scale_action
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    from torchdriveenv_tpu_torch.parallel.train_step import make_offpolicy_train_fns
    from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
    from torchdriveenv_tpu_torch.rl.evaluate import make_evaluator
    from torchdriveenv_tpu_torch.rl.rollout import init_stack, update_stack
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig

    result = {}

    # ---- a. the deliverable actor, carried across ------------------------
    out = env.step(state, act)
    stack = init_stack(out.obs, 3)
    for _ in range(2):
        out = env.step(out.state, act)
        stack = update_stack(stack, out.obs, out.terminated | out.truncated)
    actor32 = load_actor(compute_dtype=torch.float32)
    actor16 = load_actor()                       # the default: a bf16 torso
    actor_cpu = load_actor(device="cpu", compute_dtype=torch.float32)
    with torch.no_grad():
        a32 = torch.tanh(actor32(stack)[0])
        a16 = torch.tanh(actor16(stack)[0])
        a_cpu = torch.tanh(actor_cpu(stack[:256].cpu())[0])
    err = float((a32[:256].cpu() - a_cpu).abs().max())
    bf16_diff = float((a16 - a32).abs().max())
    log(f"[learner] deliverable actor on {stack.shape[0]} frame stacks: card "
        f"f32 against CPU f32 on 256 of them, max |tanh(mu)| error {err:.3e} "
        f"(atol 1e-4); bf16 torso against f32 on the card, max action "
        f"difference {bf16_diff:.3e}; actions span "
        f"[{float(a32.min()):.3f}, {float(a32.max()):.3f}] [{card}]")
    check(a32.shape == (N_ENVS, 2) and torch.isfinite(a32).all(),
          "actor output")
    check(err <= 1e-4, f"actor on the card differs from the CPU by {err}")
    result["actor"] = dict(max_abs_err_vs_cpu=err, bf16_max_action_diff=bf16_diff,
                           batch=N_ENVS)
    del stack, out, a32, a16

    # ---- b. SAC trains at the recipe's real size -------------------------
    cfg = construct_rl_training_config(_SAC).env
    agent = SAC(SACConfig(**_SAC["algo_kwargs"]))
    demo_fn = make_scripted_driver(cfg, assets)
    fns = dict(buffer_capacity=RECIPE_CAPACITY,
               steps_per_iter=RECIPE_STEPS_PER_ITER,
               updates_per_iter=RECIPE_UPDATES_PER_ITER, demo_fn=demo_fn,
               demo_envs=RECIPE_DEMO_ENVS)
    init_fn, train_step = make_offpolicy_train_fns(
        cfg, agent, RECIPE_ENVS, demo_steps=RECIPE_DEMO_STEPS, **fns)
    carry = init_fn(assets, RECIPE_SEED)
    st = agent.state
    st.actor.load_state_dict(actor16.state_dict())
    frames_gb = carry.buffer.frames.numel() / 1e9
    log(f"[learner] recipe: {RECIPE_ENVS} envs, ring of {RECIPE_CAPACITY} "
        f"cells per env = {frames_gb:.2f} GB of frames on the card (side "
        f"ring {carry.buffer.term_frames.shape[1]} slots), batch {RECIPE_BATCH}, "
        f"{RECIPE_STEPS_PER_ITER} env steps + {RECIPE_UPDATES_PER_ITER} "
        f"updates per train step; {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated")
    check(carry.buffer.frames.device == assets.device
          and carry.buffer.frames.shape == (RECIPE_ENVS, RECIPE_CAPACITY, 3, 64, 64),
          "the buffer's frames")

    def snapshot():
        return {k: {n: v.detach().clone() for n, v in m.state_dict().items()}
                for k, m in (("actor", st.actor), ("critic", st.critic),
                             ("target", st.target_critic))}

    def moved(a, b):
        return any(not torch.equal(a[n], b[n]) for n in a)

    def counted_train_step(step_fn, carry):
        """-> (carry, metrics as floats, the rasterizer's host launches)."""
        rc.render_obs_cuda.launches = 0
        carry, m = step_fn(assets, carry)
        return (carry, {k: float(v) for k, v in m.items()},
                rc.render_obs_cuda.launches)

    before = snapshot()
    log_alpha0 = st.log_alpha.detach().clone()
    for it in range(6):
        carry, m, n_launch = counted_train_step(train_step, carry)
        log(f"[learner] recipe train step {it + 1}: rasterizer host launches "
            f"{n_launch}; " + ", ".join(f"{k} {v:.4g}" for k, v in m.items())
            + f" [{card}]")
        check(n_launch == host_launches(it * RECIPE_STEPS_PER_ITER,
                                        RECIPE_STEPS_PER_ITER),
              f"{n_launch} rasterizer host launches in train step {it + 1}")
        check(all(math.isfinite(v) for v in m.values()), "non-finite metric")
        if it == 0:                 # warmup: zero metrics, the agent unchanged
            check(all(m[k] == 0.0 for k in SAC.metric_names), "warmup metrics")
            check(st.step == 0 and not any(
                moved(before[k], snapshot()[k]) for k in before),
                "the agent changed in warmup")
        else:
            check(m["critic_loss"] > 0.0, "critic_loss")
            check(m["alpha"] == 0.02 or abs(m["alpha"] - 0.02) < 1e-7, "alpha")
    after = snapshot()
    check(moved(before["critic"], after["critic"]), "the critic did not move")
    check(moved(before["target"], after["target"]), "the target did not move")
    check(not moved(before["actor"], after["actor"]), "the frozen actor moved")
    check(torch.equal(st.log_alpha.detach(), log_alpha0), "log_alpha moved")
    exported = agent.export_state()
    check(exported["actor_opt"]["step"] == 0 and exported["alpha_opt"]["step"] == 0,
          "a delayed optimizer's step count advanced")
    check(st.step == 5 * RECIPE_UPDATES_PER_ITER, f"{st.step} updates")
    n_rows = 6 * RECIPE_STEPS_PER_ITER
    check(int(carry.buffer.pos) == n_rows and carry.env_steps == n_rows * RECIPE_ENVS,
          "buffer position")
    check(bool(carry.buffer.is_demo[:, :n_rows].all()),
          "a row of the demo phase is not flagged")
    check(not bool(carry.buffer.is_demo[:, n_rows:].any()), "unwritten rows")

    # the demo phase over (demo_steps=0), same carry, same agent: only the
    # first demo_envs envs stay scripted
    _, train_step_late = make_offpolicy_train_fns(
        cfg, agent, RECIPE_ENVS, demo_steps=0, **fns)
    for it in range(2):
        carry, m, n_launch = counted_train_step(train_step_late, carry)
        check(n_launch == host_launches(it * RECIPE_STEPS_PER_ITER,
                                        RECIPE_STEPS_PER_ITER),
              "host launches, late step")
        check(all(math.isfinite(v) for v in m.values()), "non-finite metric")
    late = carry.buffer.is_demo[:, n_rows:n_rows + 2 * RECIPE_STEPS_PER_ITER]
    check(bool(late[:RECIPE_DEMO_ENVS].all())
          and not bool(late[RECIPE_DEMO_ENVS:].any()),
          "demo_envs: flags are not on the first envs only")
    check(int(carry.buffer.pos) == n_rows + 2 * RECIPE_STEPS_PER_ITER, "pos")
    log(f"[learner] demo phase over: rows {n_rows}..{int(carry.buffer.pos) - 1} "
        f"flagged on envs 0..{RECIPE_DEMO_ENVS - 1} only; buffer pos "
        f"{int(carry.buffer.pos)}, env steps {carry.env_steps}")

    # what the kernel ran in a train step of the late steps
    holder = [carry]

    def late_step():
        holder[0] = train_step_late(assets, holder[0])[0]

    _, late_counts, host = trace_runs(late_step, 2 * RECIPE_STEPS_PER_ITER)
    carry = holder[0]
    log(f"[learner] traced train steps of the late steps: rasterizer kernel "
        f"runs {late_counts}, host launches {host} [{card}]")
    check(max(late_counts) == 2 * RECIPE_STEPS_PER_ITER,
          f"kernel runs {late_counts}, late step")
    check(host == 0, "host launches, late steps that replay")
    carry = None
    result["recipe_train_step"] = dict(
        num_envs=RECIPE_ENVS, buffer_capacity=RECIPE_CAPACITY,
        frames_gb=frames_gb, batch_size=RECIPE_BATCH,
        steps_per_iter=RECIPE_STEPS_PER_ITER,
        updates_per_iter=RECIPE_UPDATES_PER_ITER,
        rasterizer_runs_per_train_step=max(late_counts),
        last_metrics=m)

    # default SAC (SB3's settings but the batch), fresh weights, no demo
    agent2 = SAC(SACConfig(batch_size=RECIPE_BATCH))
    init2, train2 = make_offpolicy_train_fns(
        EnvConfig(), agent2, RECIPE_ENVS,
        buffer_capacity=agent2.cfg.buffer_size // RECIPE_ENVS,
        steps_per_iter=RECIPE_STEPS_PER_ITER,
        updates_per_iter=RECIPE_UPDATES_PER_ITER)
    carry2 = init2(assets, 7)
    st2 = agent2.state
    actor0 = {n: v.detach().clone() for n, v in st2.actor.state_dict().items()}
    for it in range(3):
        carry2, m2, n_launch = counted_train_step(train2, carry2)
        log(f"[learner] default SAC train step {it + 1}: rasterizer host "
            f"launches {n_launch}; " + ", ".join(f"{k} {v:.4g}"
                                                for k, v in m2.items())
            + f" [{card}]")
        check(n_launch == host_launches(it * RECIPE_STEPS_PER_ITER,
                                        RECIPE_STEPS_PER_ITER),
              "host launches, default SAC")
        check(all(math.isfinite(v) for v in m2.values()), "non-finite metric")
    check(moved(actor0, st2.actor.state_dict()), "default SAC: actor did not move")
    check(float(st2.log_alpha.detach()) != 0.0 and m2["alpha"] != 1.0,
          "default SAC: alpha did not move")
    check(agent2.export_state()["actor_opt"]["step"] == 2 * RECIPE_UPDATES_PER_ITER,
          "default SAC: actor optimizer steps")
    result["default_sac_train_step"] = dict(last_metrics=m2)
    carry2 = None

    # ---- c. the evaluator -----------------------------------------------
    val = load_assets("val")
    n_cases = val.suite.case_town.shape[0]
    cases = [i % n_cases for i in range(EVAL_EPISODES)]
    reset_fn, step_fn = make_env_fns(cfg, val, render=True)
    evaluate = make_evaluator(
        reset_fn, step_fn, lambda actor, obs: torch.tanh(actor(obs)[0]), 3,
        scale_action, max_steps=EVAL_STEPS, cases=cases, n_cases=n_cases)
    g = torch.Generator(device="cuda").manual_seed(RECIPE_SEED)
    rc.render_obs_cuda.launches = 0
    metrics = {k: float(v) for k, v in
               evaluate(g, EVAL_EPISODES, actor32).items()}
    n_host = rc.render_obs_cuda.launches
    # the same evaluation again, traced: its steps all replay

    def again_fn():
        g = torch.Generator(device="cuda").manual_seed(RECIPE_SEED)
        return {k: float(v) for k, v in
                evaluate(g, EVAL_EPISODES, actor32).items()}

    again, eval_counts, eval_host = trace_runs(again_fn, EVAL_STEPS + 1)
    n_launch = max(eval_counts)
    nine = {k: v for k, v in metrics.items() if "_case_" not in k}
    log(f"[learner] evaluator: deliverable actor (f32), {EVAL_EPISODES} "
        f"validation episodes x {EVAL_STEPS} steps, rasterizer host "
        f"launches {n_host} (the reset, the eager step, the capture); the "
        f"evaluation again, traced: kernel runs {eval_counts} (1 at the reset "
        f"+ 1 per step), host launches {eval_host}, metrics "
        f"{'equal' if again == metrics else 'apart'} [{card}]")
    log("[learner] evaluator metrics: "
        + ", ".join(f"{k} {v:.4f}" for k, v in nine.items()))
    log("[learner] success per validation case: "
        + ", ".join(f"{i}: {metrics[f'success_case_{i}']:.2f}"
                    for i in range(n_cases)))
    check(len(nine) == 9 and all(math.isfinite(v) for v in metrics.values()),
          "evaluator metrics")
    for k in ("offroad_rate", "collision_rate", "traffic_light_violation_rate",
              "success_percentage"):
        check(0.0 <= metrics[k] <= 1.0, k)
    check(1.0 <= metrics["mean_episode_length"] <= EVAL_STEPS, "episode length")
    check(n_host == 1 + host_launches(0, EVAL_STEPS, renders=1),
          f"{n_host} host launches in the evaluation")
    check(n_launch == EVAL_STEPS + 1, f"{n_launch} kernel runs in the "
          "evaluation")
    check(eval_host == len(eval_counts), f"{eval_host} host launches in "
          f"{len(eval_counts)} evaluations that replay")
    result["evaluator"] = dict(episodes=EVAL_EPISODES, steps=EVAL_STEPS,
                               rasterizer_runs=n_launch,
                               rasterizer_host_launches=n_host,
                               metrics=metrics)
    return result


def synchronizing_calls(fn):
    """fn() under ``torch.cuda.set_sync_debug_mode("warn")`` -> (its result,
    {"file:line": count} of the calls from this package's code that
    synchronized the host with the device). Only frames below this
    function's own count, so a caller inside the package (a probe that
    ``main`` calls) is not taken for the mode's own notice."""
    syncs = []

    def note(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message).lower():
            stack = traceback.extract_stack()
            here = max(i for i, f in enumerate(stack)
                       if f.name == "synchronizing_calls")
            inside = [f"{os.path.basename(f.filename)}:{f.lineno}"
                      for f in stack[here + 1:]
                      if "torchdriveenv_tpu_torch" in f.filename]
            if inside:          # not the mode's own notice
                syncs.append(inside[-1])

    plain_show = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            warnings.showwarning = plain_show
    torch.cuda.synchronize()
    return out, {w: syncs.count(w) for w in sorted(set(syncs))}


RASTER_KERNEL = "render_obs_kernel"
NPC_KERNEL = "npc_gaps_kernel"


@contextlib.contextmanager
def kernel_runs(kernel: str, launcher):
    """A hand-written kernel's work inside the block, set on the yielded
    namespace at exit: ``runs``, its runs on the card, counted from the
    events named ``kernel`` of a torch.profiler trace of the block (the
    kernels a replayed CUDA graph runs are kernel events too); ``host``, its
    launches from the host (``launcher.launches``, set to 0 just before),
    which an env step that replays its graphs does not add to."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    got = types.SimpleNamespace(runs=None, host=None)
    torch.cuda.synchronize()
    launcher.launches = 0
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield got
        torch.cuda.synchronize()
    got.host = launcher.launches
    got.runs = sum(e.device_type == DeviceType.CUDA and kernel in e.name
                   for e in prof.events())


def rasterizer_runs():
    """``kernel_runs`` of the rasterizer (``render_obs_cuda``)."""
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc

    return kernel_runs(RASTER_KERNEL, rc.render_obs_cuda)


def npc_gaps_runs():
    """``kernel_runs`` of the NPC controller's kernel (``npc_gaps_cuda``)."""
    from torchdriveenv_tpu_torch.npc import route_follow as rf

    return kernel_runs(NPC_KERNEL, rf.npc_gaps_cuda)


TRACE_TRIES = 3


def trace_runs(fn, want: int, runs=rasterizer_runs):
    """fn() under ``runs()`` (the rasterizer's by default), traced again
    (TRACE_TRIES traces at most) while a trace holds fewer than ``want``
    kernel runs: the CUDA activity records of a trace can lose kernels (a
    few hundred of some 35,000-kernel traces; a render in about one trace of
    15 of 32 steps), and never add one. -> (fn's last result, the runs of
    each trace, the host launches in all of them)."""
    counts, host, out = [], 0, None
    while len(counts) < TRACE_TRIES and (not counts or counts[-1] < want):
        with runs() as got:
            out = fn()
        counts.append(got.runs)
        host += got.host
    return out, counts, host


def host_launches(first: int, n: int, renders: int = 2) -> int:
    """The rasterizer's host launches in env steps ``first`` .. ``first + n
    - 1`` of a new ``step_fn`` on the card, ``renders`` a step: in its first
    two calls (the eager one and the capture of its graphs), none in a
    replay."""
    return renders * max(0, min(first + n, 2) - first)


def host_per_step(name, rows, env_steps):
    """Each train step's host launches of the rasterizer (``rows``, a
    ``host_launches`` each), ``env_steps`` env steps a train step: those of
    a new ``step_fn``'s first two env steps, then none (its steps
    replay)."""
    for i, r in enumerate(rows):
        want = host_launches(i * env_steps, env_steps)
        check(r["host_launches"] == want,
              f"{name}: {r['host_launches']} host launches in train step "
              f"{i + 1}, not {want}")


def onpolicy_torso_launches(n_steps: int, grad_steps: int) -> int:
    """The torso input kernel's launches in an on-policy train step: an env
    step's action and the value of its terminal stack, the last stack's
    value, then one a gradient step (the torso is shared)."""
    return 2 * n_steps + 1 + grad_steps


def offpolicy_torso_launches(step: int, warm: int, env_steps: int,
                             updates: int) -> int:
    """... in train step ``step`` of an off-policy run: none in its first
    ``warm`` (random actions, no update), then an env step's action and two
    an update (its stacks and next stacks, each made once for all its
    torsos)."""
    return 0 if step < warm else env_steps + 2 * updates


def torso_per_step(name, rows, want):
    """Each train step's launches of the torso input kernel (``rows``, a
    ``torso_launches`` each) against ``want(i)`` for train step i."""
    for i, r in enumerate(rows):
        check(r["torso_launches"] == want(i),
              f"{name}: {r['torso_launches']} torso input launches in train "
              f"step {i + 1}, not {want(i)}")


# f32 operations of the NPC kernel per (agent, candidate) pair, a cosine
# counted as one: 2 sub, 2 mul, add, compare (lon); 2 mul, add (lat); sub,
# cos (the heading cosine); abs, 3 compares (the leader test); add, div,
# sub, compare (the gap against the best so far)
NPC_PAIR_OPS = 19
# ... per (agent, stopline) pair: 2 sub, 2 mul, add, 2 compares (lon); 2
# mul, add, abs, compare (lat); sub, cos, compare (aligned); 2 sub, compare
# (the gap against the best so far)
NPC_STOPLINE_OPS = 18
NPC_KERNEL_REPS = 100


def npc_gaps_bounds_ms(b, a, n_lights, n_towns):
    """Least time for one call of the NPC kernel: each agent's state,
    length and presence read and its three outputs written once (33 bytes),
    each env's town and red mask, each town's stoplines (midpoints' ends,
    heading, mask: 21 bytes a line) once; against the f32 operations of
    every (agent, other agent) and (agent, stopline) pair. Returns (bytes
    ms, operations ms)."""
    nbytes = b * a * 33 + b * (4 + n_lights) + n_towns * n_lights * 21
    ops = b * a * ((a - 1) * NPC_PAIR_OPS + n_lights * NPC_STOPLINE_OPS)
    return nbytes / PEAK_HBM_BYTES * 1e3, ops / PEAK_F32_OPS * 1e3


def npc_gaps_check(assets, state, act, card) -> dict:
    """[kernels] the NPC controller's kernel (``npc_gaps_cuda``) against its
    plain twins ``leader_gaps`` + ``light_gaps`` on the card, bit for bit,
    on the 4096-env batch ``state`` (route mode) and on a policy-mode env's
    4096-env batch after 8 steps; the kernel and the twins timed on the
    route-mode batch beside the bounds."""
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env.batched import BatchedEnv
    from torchdriveenv_tpu_torch.npc import route_follow as rf
    from torchdriveenv_tpu_torch.ops.traffic_lights import (LightState,
                                                            light_states_at)

    maps = assets.maps
    dt = EnvConfig().simulator.dt

    def compare(label, st):
        t = st.time0 + st.step_idx.float() * dt
        red = light_states_at(maps, st.town, t) != int(LightState.GREEN)
        args = (st.agent_states.contiguous(), st.agent_attrs.contiguous(),
                st.present.contiguous())
        kern = rf.npc_gaps_cuda(maps, st.town, red, *args)
        twin = (*rf.leader_gaps(*args),
                rf.light_gaps(maps, st.town, t, *args[:2]))
        torch.cuda.synchronize()
        bad, err = 0, 0.0
        for k, w in zip(kern, twin):
            bad += int((~((k == w) | (torch.isnan(k) & torch.isnan(w)))).sum())
            both = torch.isfinite(k) & torch.isfinite(w)
            if bool(both.any()):
                err = max(err, float((k - w)[both].abs().max()))
        leaders = int(torch.isfinite(twin[0]).sum())
        stops = int(torch.isfinite(twin[2]).sum())
        log(f"[kernels] npc_gaps {label}: B={st.town.shape[0]} A="
            f"{args[0].shape[1]} lights {maps.stop_dir.shape[1]}; agents with "
            f"a leader {leaders}, with a blocking stopline {stops}; "
            f"mismatched values {bad} of {3 * kern[0].numel()}")
        check(bad == 0, f"npc_gaps kernel != twins on {label}")
        check(leaders > 0 and stops > 0,
              f"npc_gaps {label}: no leader or no blocking stopline")
        return err, lambda: rf.npc_gaps_cuda(maps, st.town, red, *args), \
            lambda: (rf.leader_gaps(*args),
                     rf.light_gaps(maps, st.town, t, *args[:2]))

    err, kern_fn, twin_fn = compare("route-mode main batch", state)
    k_ms = cuda_ms(kern_fn, NPC_KERNEL_REPS)
    p_ms = cuda_ms(twin_fn, 3)
    b, a = state.agent_states.shape[:2]
    b_ms, o_ms = npc_gaps_bounds_ms(b, a, maps.stop_dir.shape[1],
                                    maps.stop_dir.shape[0])
    # As for the rasterizer: the operations are those of evaluating every
    # pair in full; a kernel that beats them skips work, and only the bytes
    # still bound it.
    bound, bound_by = (o_ms, "operations") if k_ms >= o_ms else (b_ms, "bytes")
    log(f"[kernels] npc_gaps route-mode main batch: kernel {k_ms:.4f} ms, "
        f"twins {p_ms:.4f} ms, bounds: bytes {b_ms:.4f} ms, operations "
        f"{o_ms:.4f} ms [{card}]")

    penv = BatchedEnv(EnvConfig(npc_mode="policy"), assets, N_ENVS, seed=5)
    pstate, _ = penv.reset()
    for _ in range(8):
        pstate = penv.step(pstate, act).state
    policy_err = compare("policy-mode batch after 8 steps", pstate)[0]
    del penv, pstate
    return dict(max_abs_err=err, policy_max_abs_err=policy_err, ms=k_ms,
                plain_ms=p_ms, bound_ms=bound, bound_by=bound_by,
                bytes_bound_ms=b_ms, operations_bound_ms=o_ms)


# ---- [torso]: the torso input kernel -----------------------------------

# SAC's batch (the stage-1 recipe), PPO's minibatch rows a card at four
# cards, its rollout's rows a card
TORSO_SHAPES = ((512, 9, 64, 64), (2048, 9, 64, 64), (4096, 9, 64, 64))
TORSO_REPS = 100
TORSO_KERNEL = "torso_input_kernel"
# the twin's one torch pass (a division into a channels-last tensor)
TORSO_TWIN_KERNEL = "elementwise_kernel"


def torso_input_check(card) -> dict:
    """[torso] the torso input kernel (``torso_input_cuda``) against its
    plain twin ``nhwc_input`` on the card, bit for bit and stride for
    stride, on stacks holding every byte value at the three shapes. Each
    timed by its kernel's device time (torch.profiler, 100 calls; None
    where the profiler records none) beside the bytes bound (each byte
    read and each bf16 value written once); the twin is one PyTorch call,
    so its time is the library's too. The launches on the main path are
    counted in [train]."""
    from torchdriveenv_tpu_torch.models import cnn

    g = torch.Generator(device="cuda").manual_seed(22)
    out = {}
    for shape in TORSO_SHAPES:
        obs = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8,
                            device="cuda")
        obs.view(-1)[:256] = torch.arange(256, device="cuda").to(torch.uint8)
        kern = cnn.torso_input_cuda(obs)
        twin = cnn.nhwc_input(obs, torch.bfloat16)
        torch.cuda.synchronize()
        bad = int((kern.view(torch.int16) != twin.view(torch.int16)).sum())
        err = float((kern.float() - twin.float()).abs().max())
        check(bad == 0 and kern.stride() == twin.stride(),
              f"[torso] kernel != twin at {shape}: {bad} values differ, "
              f"strides {kern.stride()} / {twin.stride()}")
        k_ms = device_ms(kernel_device_us(
            lambda: cnn.torso_input_cuda(obs), TORSO_REPS, (TORSO_KERNEL,)),
            (TORSO_KERNEL,))
        p_ms = device_ms(kernel_device_us(
            lambda: cnn.nhwc_input(obs, torch.bfloat16), TORSO_REPS,
            (TORSO_TWIN_KERNEL,)), (TORSO_TWIN_KERNEL,))
        b_ms = 3 * obs.numel() / PEAK_HBM_BYTES * 1e3
        share = (f"{100 * b_ms / k_ms:.1f} % of it" if k_ms
                 else "no kernel record")
        log(f"[torso] {shape}: kernel = twin on every value (256 byte values "
            f"among them), strides {kern.stride()}; device time a call: "
            f"kernel {k_ms} ms, twin {p_ms} ms, bytes bound {b_ms:.4f} ms "
            f"({share}) [{card}]")
        out["x".join(map(str, shape))] = dict(ms=k_ms, plain_ms=p_ms,
                                              bound_ms=b_ms, max_abs_err=err)
        del obs, kern, twin
    return dict(out["x".join(map(str, TORSO_SHAPES[0]))], shapes=out)


def npc_phase(assets, act, card, prep_of) -> dict:
    """Phase 4: the GRU NPC policy on the card. (a) The shipped weights
    on the 4096-env policy-mode batch after 8 steps, card against CPU.
    (b) The policy-mode main path at full width: 32 traced steps, then 4
    with ``with_final_obs``."""
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env.batched import BatchedEnv
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.npc import policy_net
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc

    cfg = EnvConfig(npc_mode="policy")
    env = BatchedEnv(cfg, assets, N_ENVS, seed=5)
    state, _ = env.reset()
    check(state.npc_hidden.shape == (N_ENVS, 96, policy_net.HIDDEN)
          and not state.npc_hidden.any(), "the reset's hidden state")
    for _ in range(8):
        state = env.step(state, act).state

    # ---- a. the shipped GRU, card against CPU -------------------------
    cpu = load_assets("train", device="cpu")
    t = state.time0 + state.step_idx.float() * cfg.simulator.dt
    args = (state.town, t, state.agent_states, state.agent_attrs,
            state.present, state.npc_target_speed)
    rest = (state.npc_hidden, state.agent_states, state.npc_target_speed)
    cpu_rest = [x.cpu() for x in rest]
    with torch.no_grad():
        feats = policy_net._features(assets.maps, *args)
        act_g, h_g = policy_net.policy_actions(policy_net.default_params(),
                                               feats, *rest)
        feats_c = policy_net._features(cpu.maps, *(x.cpu() for x in args))
        shipped_cpu = policy_net.default_params("cpu")
        act_c, h_c = policy_net.policy_actions(shipped_cpu, feats_c, *cpu_rest)
        # the GRU and its rules on the card's own features
        act_s, h_s = policy_net.policy_actions(shipped_cpu, feats.cpu(),
                                               *cpu_rest)
    feats, act_g, h_g = feats.cpu(), act_g.cpu(), h_g.cpu()

    def err(a, b):
        return (a - b).abs().amax(dim=-1)                      # per agent

    gru_err = float(torch.maximum(err(act_g, act_s), err(h_g, h_s)).max())
    full = torch.maximum(err(act_g, act_c), err(h_g, h_c))
    jump = err(feats, feats_c) > 1e-5       # a feature crossed a discontinuity
    fold = jump & (feats[..., 2] * feats_c[..., 2] < 0)      # sin(herr) flipped
    n_agents = full.numel()
    smooth_err = float(full[~jump].max())
    log(f"[npc] shipped GRU on {N_ENVS} x 96 agents after 8 policy-mode "
        f"steps, card (TF32 off) against the CPU: on the card's features "
        f"max |action, hidden| error {gru_err:.3e}; through the features, "
        f"{smooth_err:.3e} over the agents whose features agree to 1e-5 "
        f"(atol 1e-5); {int(jump.sum())} of {n_agents} agents have a feature "
        f"that differs by more (a rounding on either side of a "
        f"discontinuity), {int(fold.sum())} of them at the heading fold; "
        f"max over all agents {float(full.max()):.3e}")
    check(gru_err <= 1e-5, f"GRU card against CPU: {gru_err}")
    check(smooth_err <= 1e-5, f"npc_policy_actions card against CPU: "
          f"{smooth_err}")
    check(int(jump.sum()) <= 1e-4 * n_agents,
          f"{int(jump.sum())} agents' features jump")
    result = dict(gru_max_abs_err=gru_err, max_abs_err=smooth_err,
                  agents=n_agents, feature_jumps=int(jump.sum()),
                  feature_jumps_at_fold=int(fold.sum()))
    del feats, feats_c, act_g, h_g, act_c, h_c, act_s, h_s, cpu

    # ---- b. the policy-mode main path ---------------------------------
    def traced():
        nonlocal state
        for _ in range(TRACED_STEPS):
            o = env.step(state, act)
            state = o.state
        return o

    out, counts, host = trace_runs(traced, TRACED_STEPS)
    launches = max(counts)
    log(f"[npc] policy-mode main path: {N_ENVS} envs, in traces of "
        f"{TRACED_STEPS} steps, rasterizer kernel runs {counts}, host "
        f"launches {host} [{card}]")
    check(launches == TRACED_STEPS, f"{counts} kernel runs in {TRACED_STEPS} "
          "policy-mode steps")
    check(host == 0, f"{host} host launches in steps that replay their "
          "graphs")
    check(out.obs.shape == (N_ENVS, 3, 64, 64) and out.obs.dtype == torch.uint8,
          "policy-mode obs")
    check(bool(torch.isfinite(out.reward).all())
          and bool(torch.isfinite(state.agent_states).all()), "non-finite")
    check(torch.equal(out.obs, rc.render_obs_torch(assets.maps, state.town,
                                                   *prep_of(cfg, state))),
          "policy-mode obs differ from the twin's render")
    hidden = state.npc_hidden
    running = state.step_idx > 0
    npc = state.present.clone()
    npc[:, 0] = False
    check(bool(torch.isfinite(hidden).all()), "non-finite npc_hidden")
    check(bool((hidden.abs().amax(dim=-1) > 0)[running[:, None] & npc].all()),
          "a present NPC of a running env has a zero hidden state")
    check(not hidden[~running].any(), "a restarted env kept its hidden state")
    log(f"[npc] npc_hidden {tuple(hidden.shape)}: finite, non-zero for the "
        f"{int((running[:, None] & npc).sum())} present NPCs of running envs, "
        f"zero in the {int((~running).sum())} envs restarted this step; "
        f"mean |h| {float(hidden.abs().mean()):.4f}")
    _, npc_counts, npc_host = trace_runs(traced, TRACED_STEPS,
                                         runs=npc_gaps_runs)
    log(f"[npc] policy-mode main path: in traces of {TRACED_STEPS} more "
        f"steps, NPC kernel runs {npc_counts}, host launches {npc_host}")
    check(max(npc_counts) == TRACED_STEPS, f"{npc_counts} NPC kernel runs in "
          f"{TRACED_STEPS} policy-mode steps")
    check(npc_host == 0, f"{npc_host} NPC kernel host launches in steps that "
          "replay their graphs")
    out, where = synchronizing_calls(lambda: env.step(state, act))
    log(f"[npc] one policy-mode step with synchronizing calls reported: "
        f"{sum(where.values())}: {where}")
    check(not where, f"synchronizing calls in a policy-mode step: {where}")
    del env, state, out, hidden

    fenv = BatchedEnv(cfg, assets, N_ENVS, seed=6, with_final_obs=True)
    fstate, _ = fenv.reset()
    torch.cuda.synchronize()
    rc.render_obs_cuda.launches = 0
    for _ in range(2):                  # the eager step and the capture
        fstate = fenv.step(fstate, act).state
    f_host = rc.render_obs_cuda.launches

    def traced_f():
        nonlocal fstate
        for _ in range(2):
            o = fenv.step(fstate, act)
            fstate = o.state
        return o

    fout, f_counts, host = trace_runs(traced_f, 4)
    f_launches = max(f_counts)
    log(f"[npc] with_final_obs: 2 steps, rasterizer host launches {f_host} "
        f"(the eager step's and the capture's); 2 more, traced: kernel runs "
        f"{f_counts}, host launches {host}")
    check(f_launches == 4 and fout.final_obs.shape == (N_ENVS, 3, 64, 64),
          "policy mode with_final_obs")
    check(f_host == 4 and host == 0,
          f"host launches {f_host}, {host} with with_final_obs")
    result.update(traced_steps=TRACED_STEPS, num_envs=N_ENVS,
                  rasterizer_runs=launches, npc_gaps_runs=max(npc_counts),
                  synchronizing_calls_in_a_step=where,
                  with_final_obs_runs=f_launches)
    return result


def gym_phase(assets, state, card, have) -> dict:
    """Phase 5: ``render_egocentric`` (the SDF-grid birdview) on the
    card against the CPU on the main path's 4096-env state, and a 1024-pixel
    frame; the calls of the adapter's step at B = 1; then, where gymnasium
    imports, one validation episode of ``torchdriveenv-torch-v0`` with video
    and one without."""
    import numpy as np

    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env import core
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    from torchdriveenv_tpu_torch.ops.rasterizer import render_egocentric

    dt = EnvConfig().simulator.dt

    def args_of(a, st):
        t = st.time0 + st.step_idx.float() * dt
        case = st.case.long()
        return (st.town, t, st.agent_states, st.agent_attrs, st.present,
                a.suite.waypoints[case], st.target_idx,
                a.suite.n_waypoints[case])

    cpu = load_assets("train", device="cpu")
    cpu_state = core.EnvState.from_numpy(state.to_numpy(), device="cpu")
    with torch.no_grad():
        card_frames = render_egocentric(assets.maps, *args_of(assets, state))
        cpu_frames = torch.cat([
            render_egocentric(cpu.maps, *args_of(cpu, cpu_state.take(
                torch.arange(i, min(i + 512, N_ENVS)))))
            for i in range(0, N_ENVS, 512)])
        bad = (card_frames.cpu() != cpu_frames).any(dim=1)
        share = float(bad.float().mean())
        one = state.take(torch.zeros(1, dtype=torch.long, device="cuda"))
        frame = render_egocentric(assets.maps, *args_of(assets, one),
                                  res=1024, fov=500.0)
    log(f"[gym] render_egocentric at 64 px / 70 m on {N_ENVS} envs, card "
        f"against CPU: {int(bad.sum())} of {bad.numel()} pixels differ "
        f"(share {share:.3e}, limit 1e-3) [{card}]")
    check(card_frames.shape == (N_ENVS, 3, 64, 64)
          and frame.shape == (1, 3, 1024, 1024), "frame shapes")
    check(share <= 1e-3, f"render_egocentric card against CPU: {share}")
    result = dict(mismatched_pixel_share=share,
                  mismatched_pixels=int(bad.sum()))
    del card_frames, cpu_frames, cpu, cpu_state

    # the calls TorchGymEnv.step makes at B = 1 (core.step, the 64 px obs,
    # the host reads; with video also the 1024 px frame), without
    # gymnasium, which the GPU machine may lack
    val = load_assets("val")
    st0 = core.reset(EnvConfig(), val, 1,
                     torch.Generator(device="cuda").manual_seed(7))
    a1 = torch.tensor([[0.3, 0.0]], device="cuda")
    for video in (False, True):
        st = st0
        for _ in range(100):
            st, r, term, trunc, info = core.step(EnvConfig(), val, st, a1)
            render_egocentric(val.maps, *args_of(val, st))[0].cpu().numpy()
            if video:
                render_egocentric(val.maps, *args_of(val, st), res=1024,
                                  fov=500.0)[0].cpu().numpy()
            host = (float(r[0]), bool(term[0]), bool(trunc[0]),
                    {k: v[0].cpu().numpy() for k, v in info.items()})
        check(math.isfinite(host[0]), "the adapter's reward")
    log("[gym] the adapter's step at B = 1 on the card (core.step, the 64 px "
        "obs, the host reads), 100 steps, then 100 with the 1024 px / 500 m "
        "video frame: rewards finite")

    if not have["gymnasium"]:
        log("[gym] gymnasium does not import here: no Gym episode")
        return result
    import gymnasium as gym
    import torchdriveenv_tpu_torch  # noqa: F401  (registers the env id)

    def episode(mode, video):
        env = gym.make("torchdriveenv-torch-v0", args={
            "cfg": EnvConfig(render_mode=mode, video_filename=video, seed=7),
            "data": "val"})
        obs, _ = env.reset(seed=7)
        steps, done = 0, False
        while not done:
            obs, r, term, trunc, info = env.step(np.array([0.3, 0.0],
                                                          np.float32))
            steps += 1
            done = term or trunc
        env.close()
        check(obs.shape == (3, 64, 64) and np.isfinite(r), "gym step output")
        return steps

    with tempfile.TemporaryDirectory() as tmp:
        video = os.path.join(tmp, "episode.avi")
        rc.render_obs_cuda.launches = 0
        modes = ("video", "rgb_array") if have["PIL"] else ("rgb_array",)
        for mode in modes:
            steps = episode(mode, video)
            log(f"[gym] gym.make('torchdriveenv-torch-v0') {mode} episode on "
                f"the card: {steps} steps"
                + (f" (a 64 px obs and a 1024 px video frame each), video "
                   f"{os.path.getsize(video)} bytes"
                   if mode == "video" else "") + f" [{card}]")
            result[f"{mode}_episode"] = dict(steps=steps)
            if mode == "video":
                check(os.path.isfile(video) and os.path.getsize(video) > 1000,
                      "the episode's video")
                result["video_episode"]["video_bytes"] = os.path.getsize(video)
        check(rc.render_obs_cuda.launches == 0,
              "the Gym adapter launched the batched env's rasterizer")
    return result


def optional_packages() -> dict:
    """Which of the optional packages import on this machine."""
    have = {}
    for name in ("yaml", "PIL", "tensorboard", "wandb", "gymnasium"):
        try:
            importlib.import_module(name)
            have[name] = True
        except ImportError:
            have[name] = False
    return have


@contextlib.contextmanager
def probed_train(train_mod, rc):
    """While active, the train step that ``rl.train.train`` builds is
    wrapped: the rasterizer's and the torso input kernel's host launches
    per call are counted. Yields a namespace with ``rows``
    [{host_launches, torso_launches, host_start, host_end}] (the
    host clock's ends tell which train step a host event fell in) and the
    ``metrics`` of every call, the plain ``train_fn``, the ``agent``, the
    ``assets``, the agent's state right after ``init_fn`` and at the start
    of the first train step."""
    from torchdriveenv_tpu_torch.models import cnn

    probe = types.SimpleNamespace(rows=[], train_fn=None, agent=None,
                                  assets=None, initial=None, first=None,
                                  metrics=[])
    names = ("make_onpolicy_train_fns", "make_offpolicy_train_fns")
    plain = {n: getattr(train_mod, n) for n in names}

    def wrap(factory):
        def wrapped(env_cfg, agent, *args, **kw):
            init_fn, train_fn = factory(env_cfg, agent, *args, **kw)

            def probed_init(assets, seed=0):
                carry = init_fn(assets, seed)
                probe.initial = agent.export_state()
                return carry

            def counted(assets, carry):
                if probe.first is None:
                    probe.first = agent.export_state()
                n0 = rc.render_obs_cuda.launches
                k0 = cnn.torso_input_cuda.launches
                t0 = time.perf_counter()
                out = train_fn(assets, carry)
                probe.rows.append(dict(
                    host_launches=rc.render_obs_cuda.launches - n0,
                    torso_launches=cnn.torso_input_cuda.launches - k0,
                    host_start=t0, host_end=time.perf_counter()))
                probe.metrics.append(out[1])
                return out

            probe.train_fn, probe.agent = train_fn, agent
            return probed_init, counted
        return wrapped

    plain_load = train_mod.load_assets

    def load_assets(suite, **kw):
        assets = plain_load(suite, **kw)
        if suite == "train":
            probe.assets = assets
        return assets

    for n in names:
        setattr(train_mod, n, wrap(plain[n]))
    train_mod.load_assets = load_assets
    try:
        yield probe
    finally:
        for n in names:
            setattr(train_mod, n, plain[n])
        train_mod.load_assets = plain_load


def train_phase(card, have) -> dict:
    """Phase 7: ``rl.train.train`` on the card for PPO (full width), A2C,
    TD3 and the stage-1 SAC recipe with the GRU NPCs, from RECIPES."""
    from torchdriveenv_tpu_torch import config as tconfig
    from torchdriveenv_tpu_torch.models import cnn
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    from torchdriveenv_tpu_torch.rl import train as train_mod

    if have["yaml"]:            # the files themselves give the same configs
        for path, raw in RECIPES.items():
            from_file = tconfig.load_rl_training_config(path)
            check(dataclasses.asdict(from_file) == dataclasses.asdict(
                tconfig.construct_rl_training_config(copy.deepcopy(raw))),
                f"{path} and its dict in this script differ")
        log(f"[train] {len(RECIPES)} YAML files load to the configs of RECIPES")

    def config_of(path, tmp, total):
        """The recipe with the overrides this phase allows itself: the
        depth, where it writes, one evaluation at the start, no video."""
        raw = copy.deepcopy(RECIPES[path])
        raw.update(total_timesteps=total, log_dir=os.path.join(tmp, "runs"),
                   checkpoint_dir=os.path.join(tmp, "ckpt"))
        raw["eval_val_callback"].update(n_steps=10 ** 9, record=False)
        raw["eval_train_callback"].update(n_steps=10 ** 9)
        return tconfig.construct_rl_training_config(raw)

    def run(name, cfg, other_launches, **kw):
        """One ``train`` call -> (carry, probe, per-step rows of host
        launches of the rasterizer and the torso input kernel, the JSONL
        records). Both host launch counts are set to 0 just before and read
        just after; ``other_launches``: the rasterizer's outside the train
        steps."""
        with probed_train(train_mod, rc) as probe:
            torch.cuda.synchronize()
            rc.render_obs_cuda.launches = 0
            cnn.torso_input_cuda.launches = 0
            t0 = time.perf_counter()
            carry = train_mod.train(cfg, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = rc.render_obs_cuda.launches
            torso = cnn.torso_input_cuda.launches
        rows = [{k: r[k] for k in ("host_launches", "torso_launches")}
                for r in probe.rows]
        logs = sorted(f for f in os.listdir(cfg.log_dir) if f.endswith(".jsonl"))
        with open(os.path.join(cfg.log_dir, logs[-1])) as f:
            records = [json.loads(line) for line in f]
        for rec in records:
            check(all(math.isfinite(v) for v in rec.values()),
                  f"{name}: non-finite value in {rec}")
        for prefix in ("train/", "eval/", "eval_train/"):
            check(any(k.startswith(prefix) for r in records for k in r),
                  f"{name}: no {prefix} record")
        check(any("eval/success_case_0" in r for r in records),
              f"{name}: no per-case validation record")
        in_steps = sum(r["host_launches"] for r in rows)
        check(launches == in_steps + other_launches,
              f"{name}: {launches} host launches, {in_steps} in train steps")
        torso_in_steps = [r["torso_launches"] for r in rows]
        check(torso >= sum(torso_in_steps),
              f"{name}: {torso} torso input launches, {torso_in_steps} in "
              "train steps")
        log(f"[train] {name}: {len(rows)} train steps in {wall:.1f} s wall "
            f"(evaluations and checkpoints included), rasterizer host "
            f"launches {launches} = {in_steps} in train steps + "
            f"{other_launches} at the first reset and in the two evaluations; "
            f"torso input launches {torso}, per train step {torso_in_steps} "
            f"[{card}]")
        launched[name] = launches
        torso_launched[name] = torso_in_steps
        return carry, probe, rows, records

    def moved(before, after):
        return any(not torch.equal(before[k], after[k]) for k in before)

    def traced_train_step(name, probe, carry, env_steps):
        """One more train step of the run's own train function, traced (a
        few, where a trace lost a kernel record) -> (carry, the
        rasterizer's kernel runs): two an env step, and no host launch
        (every env step replays)."""
        holder = [carry]

        def one():
            holder[0] = probe.train_fn(probe.assets, holder[0])[0]

        _, counts, host = trace_runs(one, 2 * env_steps)
        log(f"[train] {name}: one more train step, traced: rasterizer kernel "
            f"runs {counts}, host launches {host} [{card}]")
        check(max(counts) == 2 * env_steps,
              f"{name}: {counts} kernel runs in a train step")
        check(host == 0, f"{name}: {host} host launches in train steps that "
              "replay")
        return holder[0], max(counts)

    # outside its train steps a run launches the rasterizer from the host at
    # the first reset and, in each of its two evaluations, at the reset and
    # in the evaluator's first two steps (the eager one and the capture)
    eval_launches = 1 + 2 * (1 + host_launches(
        0, _ENV["max_environment_steps"], renders=1))
    launched, torso_launched = {}, {}
    result = {"optional_packages": have, "rasterizer_host_launches": launched,
              "torso_input_launches": torso_launched}
    torch.cuda.reset_peak_memory_stats()

    # ---- PPO at full width ----------------------------------------------
    ppo = RECIPES[PPO_YML]
    n_envs, n_steps = ppo["parallel_env_num"], ppo["algo_kwargs"]["n_steps"]
    per_step = n_envs * n_steps
    grad_steps = (ppo["algo_kwargs"]["n_epochs"]
                  * (per_step // ppo["algo_kwargs"]["batch_size"]))
    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_of(PPO_YML, tmp, PPO_TRAIN_STEPS * per_step)
        carry, probe, rows, records = run("PPO", cfg, eval_launches)
        log(f"[train] PPO rasterizer host launches per train step "
            f"{[r['host_launches'] for r in rows]} [{card}]")
        host_per_step("PPO", rows, n_steps)
        torso_per_step("PPO", rows,
                       lambda i: onpolicy_torso_launches(n_steps, grad_steps))
        last = [r for r in records if "train/loss" in r][-1]
        log("[train] PPO last train record: "
            + ", ".join(f"{k[6:]} {v:.4g}" for k, v in last.items()
                        if k.startswith("train/")))
        check(len(rows) == PPO_TRAIN_STEPS
              and carry.env_steps == PPO_TRAIN_STEPS * per_step, "PPO: depth")
        check(carry.rollout.obs_stack.shape == (n_envs, 9, 64, 64),
              "PPO: frame stacks")
        after = probe.agent.export_state()
        check(moved(probe.initial["net"], after["net"]), "PPO: parameters")
        check(not torch.equal(probe.initial["net"]["log_std"],
                              after["net"]["log_std"]), "PPO: log_std")
        check(after["opt"]["step"] == PPO_TRAIN_STEPS * grad_steps
              and after["step"] == PPO_TRAIN_STEPS,
              f"PPO: Adam count {after['opt']['step']}")
        check(probe.agent.state.net.torso.compute_dtype == torch.bfloat16,
              "PPO: the torso's dtype")
        model = os.path.join(cfg.checkpoint_dir, f"model_{carry.env_steps}")
        full = os.path.join(cfg.checkpoint_dir, "full_latest")
        check(os.path.isfile(model) and os.path.isfile(full),
              "PPO: checkpoint files")
        rollout_gb = per_step * 9 * 64 * 64 / 1e9
        log(f"[train] PPO: {n_envs} envs x {n_steps} steps = {per_step} "
            f"transitions per train step ({rollout_gb:.2f} GB of stacked "
            f"frames), {grad_steps} gradient steps of "
            f"{ppo['algo_kwargs']['batch_size']}; Adam count "
            f"{after['opt']['step']}; model_{carry.env_steps} "
            f"{os.path.getsize(model) / 1e6:.1f} MB, full_latest "
            f"{os.path.getsize(full) / 1e6:.1f} MB; peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB allocated")

        # one more train step with every synchronizing call reported: a
        # train step must not read the device from the host, nor upload
        # host data
        (carry, _), where = synchronizing_calls(
            lambda: probe.train_fn(probe.assets, carry))
        log(f"[train] one PPO train step with synchronizing calls reported: "
            f"{sum(where.values())}: {where}")
        check(not where, f"PPO: synchronizing calls in a train step: {where}")
        carry, ppo_runs = traced_train_step("PPO", probe, carry, n_steps)
        del carry, probe

        # resumed from full_latest: one more train step of the same run
        cfg2 = config_of(PPO_YML, tmp, (PPO_TRAIN_STEPS + 1) * per_step)
        carry2, probe2, rows2, _ = run("PPO resumed", cfg2, eval_launches,
                                       resume_from=full)
        check(len(rows2) == 1, "PPO resumed: one train step")
        host_per_step("PPO resumed", rows2, n_steps)
        torso_per_step("PPO resumed", rows2,
                       lambda i: onpolicy_torso_launches(n_steps, grad_steps))
        check(carry2.env_steps == (PPO_TRAIN_STEPS + 1) * per_step,
              f"PPO resumed: env_steps {carry2.env_steps}")
        resumed = probe2.agent.export_state()
        check(resumed["opt"]["step"] == (PPO_TRAIN_STEPS + 1) * grad_steps
              and resumed["step"] == PPO_TRAIN_STEPS + 1,
              f"PPO resumed: Adam count {resumed['opt']['step']}")
        check(moved(after["net"], resumed["net"]), "PPO resumed: parameters")
        log(f"[train] PPO resumed from full_latest: env steps "
            f"{PPO_TRAIN_STEPS * per_step} -> {carry2.env_steps}, Adam count "
            f"{resumed['opt']['step']}")
        del carry2, probe2
    result["ppo_1024"] = dict(
        source=PPO_YML, num_envs=n_envs, n_steps=n_steps,
        batch_size=ppo["algo_kwargs"]["batch_size"],
        gradient_steps_per_train_step=grad_steps, rollout_frames_gb=rollout_gb,
        train_steps=rows, resumed_train_step=rows2[0],
        rasterizer_runs_per_train_step=ppo_runs,
        synchronizing_calls_in_a_train_step=where,
        last_metrics={k[6:]: v for k, v in last.items()
                      if k.startswith("train/")})

    # ---- A2C and TD3 from their short-run recipes -------------------------
    from torchdriveenv_tpu_torch.rl.a2c import A2CConfig
    from torchdriveenv_tpu_torch.rl.td3 import TD3Config
    for name, path, depth, steps_per_iter in (
            ("A2C", A2C_YML, A2C_TRAIN_STEPS, A2CConfig().n_steps),
            ("TD3", TD3_YML, TD3_TRAIN_STEPS,
             tconfig.RlTrainingConfig().offpolicy_steps_per_iter)):
        n_envs = RECIPES[path]["parallel_env_num"]
        with tempfile.TemporaryDirectory() as tmp:
            cfg = config_of(path, tmp, depth * steps_per_iter * n_envs)
            carry, probe, rows, records = run(name, cfg, eval_launches)
            check(len(rows) == depth
                  and carry.env_steps == depth * steps_per_iter * n_envs,
                  f"{name}: depth")
            host_per_step(name, rows, steps_per_iter)
            warm = -(-TD3Config().learning_starts
                     // (steps_per_iter * n_envs)) if name == "TD3" else 0
            upi = tconfig.RlTrainingConfig().offpolicy_updates_per_iter
            torso_per_step(name, rows, (
                lambda i: onpolicy_torso_launches(steps_per_iter, 1))
                if name == "A2C" else (lambda i: offpolicy_torso_launches(
                    i, warm, steps_per_iter, upi)))
            after = probe.agent.export_state()
            files = sorted(os.listdir(cfg.checkpoint_dir))
            check(f"model_{carry.env_steps}" in files
                  and "full_latest" in files, f"{name}: checkpoint files")
            if name == "A2C":
                check(moved(probe.initial["net"], after["net"]),
                      "A2C: parameters")
                check(after["opt"]["step"] == depth == after["step"],
                      f"A2C: Adam count {after['opt']['step']}")
                counts = dict(adam=after["opt"]["step"])
            else:
                updates = (depth - warm) * upi    # warm: train steps of warmup
                for k in ("actor", "critic", "target_actor", "target_critic"):
                    check(moved(probe.initial[k], after[k]), f"TD3: {k}")
                check(after["step"] == updates
                      == after["critic_opt"]["step"],
                      f"TD3: {after['step']} updates")
                # the actor steps on even updates only
                check(after["actor_opt"]["step"] == updates // 2,
                      f"TD3: actor Adam count {after['actor_opt']['step']}")
                check(int(carry.buffer.pos) == depth * steps_per_iter,
                      "TD3: buffer position")
                counts = dict(updates=updates,
                              critic_adam=after["critic_opt"]["step"],
                              actor_adam=after["actor_opt"]["step"],
                              buffer_frames_gb=carry.buffer.frames.numel() / 1e9)
            last = [r for r in records if any(k.startswith("train/")
                                              for k in r)][-1]
            log(f"[train] {name}: {n_envs} envs, {steps_per_iter} env steps "
                f"per train step, {depth} train steps = {carry.env_steps} "
                f"env steps; " + ", ".join(
                    f"{k} {v}" for k, v in counts.items()) + "; last record: "
                + ", ".join(f"{k[6:]} {v:.4g}" for k, v in last.items()
                            if k.startswith("train/")) + f" [{card}]")
            carry, runs = traced_train_step(name, probe, carry, steps_per_iter)
            result[name.lower()] = dict(
                source=path, num_envs=n_envs, train_steps=depth,
                env_steps=carry.env_steps,
                rasterizer_runs_per_train_step=runs, **counts)
            del carry, probe

    # ---- stage-1 SAC with the GRU driving every NPC -----------------------
    from torchdriveenv_tpu_torch.rl.sac import SACConfig
    npc = RECIPES[NPC_SAC_YML]
    n_envs, spi = npc["parallel_env_num"], npc["offpolicy_steps_per_iter"]
    upi = npc["offpolicy_updates_per_iter"]
    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_of(NPC_SAC_YML, tmp, NPC_SAC_TRAIN_STEPS * spi * n_envs)
        check(cfg.env.npc_mode == "policy", "the recipe's npc_mode")
        carry, probe, rows, records = run("SAC npc policy", cfg, eval_launches)
        check(len(rows) == NPC_SAC_TRAIN_STEPS
              and carry.env_steps == NPC_SAC_TRAIN_STEPS * spi * n_envs,
              "SAC npc policy: depth")
        host_per_step("SAC npc policy", rows, spi)
        warm = -(-SACConfig().learning_starts // (spi * n_envs))
        torso_per_step("SAC npc policy", rows,
                       lambda i: offpolicy_torso_launches(i, warm, spi, upi))
        hidden = carry.rollout.env_state.npc_hidden
        check(hidden is not None and hidden.shape == (n_envs, 96, 16)
              and bool(torch.isfinite(hidden).all())
              and float(hidden.abs().max()) > 0.0,
              "SAC npc policy: npc_hidden is not carried")
        after = probe.agent.export_state()
        updates = (NPC_SAC_TRAIN_STEPS - warm) * upi
        check(after["step"] == updates and after["critic_opt"]["step"] == updates,
              f"SAC npc policy: {after['step']} updates")
        check(moved(probe.initial["critic"], after["critic"]),
              "SAC npc policy: the critic did not move")
        check(not moved(probe.initial["actor"], after["actor"]),
              "SAC npc policy: the frozen actor moved")
        frames_gb = carry.buffer.frames.numel() / 1e9
        last = [r for r in records if any(k.startswith("train/")
                                          for k in r)][-1]
        log(f"[train] SAC npc policy ({NPC_SAC_YML}): {n_envs} envs, ring of "
            f"{frames_gb:.2f} GB, {NPC_SAC_TRAIN_STEPS} train steps of "
            f"{spi} env steps + {upi} updates of "
            f"{npc['algo_kwargs']['batch_size']}; {updates} updates; "
            f"npc_hidden {tuple(hidden.shape)} mean |h| "
            f"{float(hidden.abs().mean()):.4f}; last record: "
            + ", ".join(f"{k[6:]} {v:.4g}" for k, v in last.items()
                        if k.startswith("train/")) + f" [{card}]")
        carry, runs = traced_train_step("SAC npc policy", probe, carry, spi)
        result["sac_npcpolicy"] = dict(
            source=NPC_SAC_YML, num_envs=n_envs, train_steps=rows,
            updates=updates, buffer_frames_gb=frames_gb,
            rasterizer_runs_per_train_step=runs,
            npc_hidden_mean_abs=float(hidden.abs().mean()))
        del carry, probe, hidden
    return result


# ---- the [tools] phase: the deliverable workflow around training ---------
# TRAINING.md:226-231: BC pretrain, rl.train --init_model, the checkpoint
# sweep; then the NPC distillation, the diagnostics and the audit. The BC
# widths are the deliverable's own command.
BC_ENVS, BC_ROLLOUT_STEPS, BC_STEPS = 128, 600, 3000
BC_BATCH, BC_INIT_ALPHA = 512, 0.05                    # bc_pretrain's defaults
TOOLS_TRAIN_STEPS = 2
TOOLS_EVAL_EPISODES = 25
DISTILL_STEPS, DISTILL_BATCH = 1500, 256               # distill_npc's defaults
DIAG_EPISODES, DIAG_MAX_STEPS = 16, 50                 # cut from the horizon, 200


@contextlib.contextmanager
def probed_bc(bc_mod, rc):
    """While active, ``bc_pretrain``'s two stages are wrapped as its
    ``main`` calls them: the demo collection's rasterizer launches are
    counted, and the shapes, bytes and action range of its pairs noted;
    the BC phase runs under ``synchronizing_calls``. Yields a namespace of
    those readings."""
    probe = types.SimpleNamespace()
    plain = bc_mod.collect_demo_pairs, bc_mod.bc_phase

    def collect(*args, **kw):
        n0 = rc.render_obs_cuda.launches
        stacks, acts = plain[0](*args, **kw)
        probe.collect_launches = rc.render_obs_cuda.launches - n0
        probe.stacks, probe.acts = ((tuple(t.shape), t.dtype, t.device.type)
                                    for t in (stacks, acts))
        probe.pairs_gb = sum(t.numel() * t.element_size()
                             for t in (stacks, acts)) / 1e9
        probe.acts_finite = bool(torch.isfinite(acts).all())
        probe.acts_max = float(acts.abs().max())
        return stacks, acts

    def phase(actor, stacks, acts, steps, *args, **kw):
        mses, probe.syncs = synchronizing_calls(
            lambda: plain[1](actor, stacks, acts, steps, *args, **kw))
        return mses

    bc_mod.collect_demo_pairs, bc_mod.bc_phase = collect, phase
    try:
        yield probe
    finally:
        bc_mod.collect_demo_pairs, bc_mod.bc_phase = plain


def tools_phase(card) -> dict:
    """Phase 8: the port's tools on the card, in the deliverable's order."""
    from torchdriveenv_tpu_torch import config as tconfig
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env import core
    from torchdriveenv_tpu_torch.env.batched import BatchedEnv
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.npc import policy_net
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    from torchdriveenv_tpu_torch.rl import train as train_mod
    from torchdriveenv_tpu_torch.tools import (
        audit_map_fidelity,
        bc_pretrain,
        diagnose_val,
        distill_npc,
        eval_checkpoints,
    )

    result, launched = {}, {}
    result["rasterizer_host_launches"] = launched
    assets = load_assets("train")
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 1. the BC warm start: bc_pretrain's command at its width ----
        cfg = EnvConfig()
        bc_path = os.path.join(tmp, "bc_init")
        with probed_bc(bc_pretrain, rc) as probe:
            rc.render_obs_cuda.launches = 0
            res = bc_pretrain.main([
                "--envs", str(BC_ENVS), "--rollout_steps",
                str(BC_ROLLOUT_STEPS), "--bc_steps", str(BC_STEPS), "--out",
                bc_path])
            launched["bc_pretrain"] = rc.render_obs_cuda.launches
        n_pairs = BC_ENVS * BC_ROLLOUT_STEPS
        check(launched["bc_pretrain"] == probe.collect_launches
              == 1 + host_launches(0, BC_ROLLOUT_STEPS, renders=1),
              f"BC: {launched['bc_pretrain']} rasterizer host launches "
              f"({probe.collect_launches} in the collection) for "
              f"{BC_ROLLOUT_STEPS} steps and a reset")
        check(res["pairs"] == n_pairs
              and probe.stacks == ((n_pairs, 9, 64, 64), torch.uint8, "cuda")
              and probe.acts == ((n_pairs, 2), torch.float32, "cuda"),
              f"BC pairs: {res['pairs']} {probe.stacks} {probe.acts}")
        check(probe.acts_finite and probe.acts_max <= 1.0 + 1e-6,
              f"BC actions: finite {probe.acts_finite}, max "
              f"{probe.acts_max}")
        check(not probe.syncs, f"BC: synchronizing calls in the BC phase: "
              f"{probe.syncs}")
        log(f"[tools] bc_pretrain.main collection: {BC_ENVS} envs x "
            f"{BC_ROLLOUT_STEPS} steps = {n_pairs} pairs "
            f"({probe.pairs_gb:.2f} GB on the card); rasterizer host "
            f"launches {launched['bc_pretrain']} in the whole command (the "
            f"reset, the eager step, the capture) [{card}]")
        mses = res["mses"]
        mse_first, mse_last = float(mses[0]), float(mses[-100:].mean())
        check(mses.shape == (BC_STEPS,) and bool(torch.isfinite(mses).all())
              and mse_last < mse_first,
              f"BC: action-MSE {mse_first} -> {mse_last}")
        tree = train_mod.restore_checkpoint(bc_path)
        check(tree["actor_opt"]["step"] == 0 and abs(
            float(tree["log_alpha"]) - math.log(BC_INIT_ALPHA)) < 1e-6,
            "BC checkpoint: actor Adam count or log_alpha")
        log(f"[tools] bc_pretrain.main BC {BC_STEPS} steps of {BC_BATCH}: "
            f"action-MSE {mse_first:.4f} -> {mse_last:.4f} (mean of the "
            f"last 100); synchronizing calls in the {BC_STEPS} steps: 0 "
            f"[{card}]")
        result["bc"] = dict(
            envs=BC_ENVS, rollout_steps=BC_ROLLOUT_STEPS, bc_steps=BC_STEPS,
            batch=BC_BATCH, pairs=n_pairs, pairs_gb=probe.pairs_gb,
            mse_first=mse_first, mse_last100_mean=mse_last,
            synchronizing_calls_per_step=0)
        del res, mses, probe

        # ---- 2. rl.train --init_model from the stage-1 recipe -----------
        raw = copy.deepcopy(RECIPES[SAC_YML])
        n_envs, spi = raw["parallel_env_num"], raw["offpolicy_steps_per_iter"]
        per_step = n_envs * spi
        ckpt_dir = os.path.join(tmp, "ckpt")
        raw.update(total_timesteps=TOOLS_TRAIN_STEPS * per_step,
                   log_dir=os.path.join(tmp, "runs"), checkpoint_dir=ckpt_dir)
        raw["eval_val_callback"].update(n_steps=10 ** 9, record=False)
        raw["eval_train_callback"].update(n_steps=10 ** 9)
        raw["wandb_callback"].update(model_save_freq=per_step)
        tcfg = tconfig.construct_rl_training_config(raw)
        with probed_train(train_mod, rc) as probe:
            torch.cuda.synchronize()
            rc.render_obs_cuda.launches = 0
            t0 = time.perf_counter()
            carry = train_mod.train(tcfg, init_model=bc_path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched["init_model_train"] = rc.render_obs_cuda.launches
        rows = [{"host_launches": r["host_launches"]} for r in probe.rows]
        check(len(rows) == TOOLS_TRAIN_STEPS
              and carry.env_steps == TOOLS_TRAIN_STEPS * per_step,
              "init_model run: depth")
        host_per_step("init_model run", rows, spi)
        first, after = probe.first, probe.agent.export_state()
        for k, v in tree["actor"].items():
            check(torch.equal(first["actor"][k], v),
                  f"init_model run: the starting actor's {k} is not BC's")
            # the recipe freezes the actor (actor_delay_updates)
            check(torch.equal(after["actor"][k], v),
                  f"init_model run: the frozen actor's {k} moved")
        check(first["actor_opt"]["step"] == 0 and abs(
            float(first["log_alpha"]) - math.log(BC_INIT_ALPHA)) < 1e-6,
            "init_model run: the starting Adam count or log_alpha")
        warm = -(-probe.agent.cfg.learning_starts // per_step)
        updates = (TOOLS_TRAIN_STEPS - warm) * raw["offpolicy_updates_per_iter"]
        check(after["step"] == updates, f"init_model run: {after['step']} "
              f"updates")
        models = eval_checkpoints.model_names(ckpt_dir)
        check(models == [f"model_{(i + 1) * per_step}"
                         for i in range(TOOLS_TRAIN_STEPS)],
              f"init_model run: checkpoints {models}")
        log(f"[tools] rl.train --init_model ({SAC_YML}): {TOOLS_TRAIN_STEPS} "
            f"train steps, {updates} updates, {wall:.1f} s wall with one "
            f"evaluation; "
            f"the starting actor is BC's, Adam count 0; wrote {models} "
            f"[{card}]")
        result["init_model_train"] = dict(
            source=SAC_YML, train_steps=rows, updates=updates, wall_s=wall,
            checkpoints=models)
        del carry, probe, first, after

        # ---- 3. the checkpoint sweep: BC and the run's model_* ----------
        shutil.copy(bc_path, os.path.join(ckpt_dir, "model_0"))
        torch.cuda.synchronize()
        rc.render_obs_cuda.launches = 0
        t0 = time.perf_counter()
        sweep = eval_checkpoints.main([
            "--ckpt_dir", ckpt_dir, "--episodes", str(TOOLS_EVAL_EPISODES),
            "--out", os.path.join(tmp, "sweep.json")])
        torch.cuda.synchronize()
        sweep_s = time.perf_counter() - t0
        launched["eval_checkpoints"] = rc.render_obs_cuda.launches
        horizon = cfg.max_environment_steps
        check([r["step"] for r in sweep] == [0] + [
            (i + 1) * per_step for i in range(TOOLS_TRAIN_STEPS)],
            "eval_checkpoints: order")
        # each checkpoint's evaluation makes its own env functions
        check(launched["eval_checkpoints"] == len(sweep) * (
            1 + host_launches(0, horizon, renders=1)),
            f"eval_checkpoints: {launched['eval_checkpoints']} host launches")
        for r in sweep:
            check(all(math.isfinite(v) for k, v in r.items()
                      if k != "checkpoint"), f"eval_checkpoints: {r}")
        log(f"[tools] eval_checkpoints over {len(sweep)} checkpoints x "
            f"{TOOLS_EVAL_EPISODES} val episodes in {sweep_s:.1f} s: "
            + "; ".join(f"{r['checkpoint']} success "
                        f"{r['success_percentage']:.2f} (cases "
                        + " ".join(f"{r[f'success_case_{i}']:.2f}"
                                   for i in range(5))
                        + f"), reward {r['mean_episode_reward']:.1f}"
                        for r in sweep) + f" [{card}]")
        # the recipe freezes the actor, so every checkpoint acts as BC does
        same = all({k: v for k, v in r.items() if k not in ("checkpoint",
                                                           "step")}
                   == {k: v for k, v in sweep[0].items()
                       if k not in ("checkpoint", "step")} for r in sweep)
        log(f"[tools] eval_checkpoints: the checkpoints' metrics are "
            f"{'identical' if same else 'not identical'} (one actor)")
        result["eval_checkpoints"] = dict(episodes=TOOLS_EVAL_EPISODES,
                                          seconds=sweep_s, rows=sweep,
                                          identical_metrics=same)

        # ---- 4. the NPC distillation ------------------------------------
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = distill_npc.main(["--steps", str(DISTILL_STEPS), "--batch",
                                str(DISTILL_BATCH), "--out",
                                os.path.join(tmp, "npc_gru.npz")])
        torch.cuda.synchronize()
        distill_s = time.perf_counter() - t0
        loaded = policy_net.load_npc_policy(res["path"])
        for k, v in res["policy"].state_dict().items():
            check(torch.equal(loaded.state_dict()[k], v),
                  f"distilled GRU: {k} differs once loaded back")
        scenes = core.reset(cfg, assets, DISTILL_BATCH,
                            torch.Generator(device="cuda").manual_seed(9))
        with torch.no_grad():
            loss_mine = float(policy_net.distill_loss(loaded, assets.maps,
                                                      scenes))
            loss_shipped = float(policy_net.distill_loss(
                policy_net.default_params(), assets.maps, scenes))
        check(math.isfinite(res["loss"]) and math.isfinite(loss_mine),
              "distillation loss")
        pcfg = EnvConfig(npc_mode="policy")
        penv = BatchedEnv(pcfg, assets, N_ENVS, seed=5, npc_params=loaded)
        pstate, _ = penv.reset()
        act = torch.zeros((N_ENVS, 2), device="cuda")
        torch.cuda.synchronize()
        rc.render_obs_cuda.launches = 0
        for _ in range(4):
            pout = penv.step(pstate, act)
            pstate = pout.state
        torch.cuda.synchronize()
        launched["distilled_policy_steps"] = rc.render_obs_cuda.launches
        hidden = pstate.npc_hidden
        check(launched["distilled_policy_steps"] == host_launches(
            0, 4, renders=1) and bool(torch.isfinite(hidden).all())
              and float(hidden.abs().max()) > 0.0
              and bool(torch.isfinite(pstate.agent_states).all()),
              "policy-mode steps with the distilled GRU")
        log(f"[tools] distill_npc: {DISTILL_STEPS} steps of {DISTILL_BATCH} "
            f"scenes in {distill_s:.1f} s, final imitation MSE "
            f"{res['loss']:.4f}; on {DISTILL_BATCH} fresh scenes "
            f"{loss_mine:.4f} (the "
            f"shipped GRU {loss_shipped:.4f}); loaded back equal; 4 "
            f"policy-mode steps of {N_ENVS} envs with it, mean |h| "
            f"{float(hidden.abs().mean()):.4f} [{card}]")
        result["distill"] = dict(
            steps=DISTILL_STEPS, batch=DISTILL_BATCH, seconds=distill_s,
            final_loss=res["loss"], loss_on_fresh_scenes=loss_mine,
            shipped_loss_on_fresh_scenes=loss_shipped)
        del penv, pstate, pout, hidden, scenes

        # ---- 5. the validation diagnostics, six probes ------------------
        val = load_assets("val")
        bc_agent = diagnose_val.restore_agent(bc_path, 9)
        torch.cuda.synchronize()
        rc.render_obs_cuda.launches = 0
        t0 = time.perf_counter()
        diag = diagnose_val.diagnose(
            diagnose_val.probe_config(), val, "val", diagnose_val.PROBES,
            DIAG_EPISODES, 5, seed=0, agent=bc_agent,
            max_steps=DIAG_MAX_STEPS)
        torch.cuda.synchronize()
        diag_s = time.perf_counter() - t0
        launched["diagnose_sac_probe"] = rc.render_obs_cuda.launches
        check(sorted(diag) == sorted(diagnose_val.PROBES)
              and all(len(rows) == 5 for rows in diag.values()),
              "diagnose_val: probes or cases")
        check(launched["diagnose_sac_probe"] == 5 * (1 + DIAG_MAX_STEPS),
              f"diagnose_val: {launched['diagnose_sac_probe']} launches")
        counts = {kind: {c: sum(r["counts"][c] for r in rows)
                         for c in diagnose_val.CAUSES}
                  for kind, rows in diag.items()}
        for kind, c in counts.items():
            check(sum(c.values()) == 5 * DIAG_EPISODES,
                  f"diagnose_val {kind}: {c}")
        log(f"[tools] diagnose_val: 6 probes x 5 val cases x {DIAG_EPISODES} "
            f"episodes x {DIAG_MAX_STEPS} steps in {diag_s:.1f} s (sac = the "
            f"BC checkpoint): " + "; ".join(
                f"{kind} " + " ".join(f"{k}={v}" for k, v in c.items())
                for kind, c in counts.items()) + f" [{card}]")
        result["diagnose_val"] = dict(
            episodes=DIAG_EPISODES, max_steps=DIAG_MAX_STEPS,
            seconds=diag_s, counts=counts,
            mean_reached={kind: [r["mean_reached"] for r in rows]
                          for kind, rows in diag.items()})
        del bc_agent, diag

        # ---- 6. the map audit on the card against the CPU ---------------
        audit_json = os.path.join(tmp, "audit.json")
        t0 = time.perf_counter()
        rc_audit = audit_map_fidelity.main(["--json", audit_json])
        audit_s = time.perf_counter() - t0
        with open(audit_json) as f:
            on_card = json.load(f)
        on_cpu = audit_map_fidelity.audit("cpu")
        worst = 0.0
        for got, (name, want) in zip(on_card, on_cpu):
            check(got["check"] == name, "audit: order")
            for k, w in want.items():
                if isinstance(w, float):
                    worst = max(worst, abs(got[k] - w))
                else:
                    check(got[k] == w, f"audit {name} {k}: card {got[k]}, "
                          f"CPU {w}")
        check(rc_audit == 0 and worst <= 1e-4,
              f"audit: exit code {rc_audit}, worst float {worst}")
        log(f"[tools] audit_map_fidelity on the card: {len(on_card)} checks, "
            f"{sum(r['n'] for r in on_card)} items, violations "
            f"{sum(r['violations'] for r in on_card)}, counts equal to the "
            f"CPU's, worst float difference {worst:.2e}, {audit_s:.1f} s")
        result["audit"] = dict(checks=len(on_card), seconds=audit_s,
                               violations=sum(r["violations"]
                                              for r in on_card),
                               worst_float_vs_cpu=worst)
    return result


# ---- the [multi] phase: data parallelism over torch.distributed ----------
# its ranks are subprocesses of this script (``--multi-worker``), so no
# process group outlives the phase
MULTI_ENVS = 4096          # the route-mode rollout: 2048 envs per rank
MULTI_STEPS = 8
MULTI_SMALL_ENVS = 64      # the sharded SAC / PPO train steps
MULTI_TIMEOUT_S = 480      # per subprocess
# the world-1 SAC step: the stage-1 recipe shrunk to a 64-cell ring and 4
# updates per train step; the world-1 PPO step: ppo_1024.yml's recipe at 256
# envs, 8 steps per rollout, minibatches of 1024
W1_SAC_CAPACITY, W1_SAC_UPDATES = 64, 4
W1_PPO_ENVS = 256
W1_PPO_KW = dict(RECIPES[PPO_YML]["algo_kwargs"], n_steps=8, batch_size=1024)
# the Adam-parity tolerance of the CPU tests (tests/test_torch_sac.py)
ADAM_ATOL, ADAM_SCALE_RTOL = 2e-5, 1e-5


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def adam_close(got: dict, want: dict) -> dict:
    """The CPU tests' Adam-parity check over two ``export_state`` trees:
    each float tensor within atol 2e-5 plus 1e-5 of its largest magnitude
    but for at most 4 elements (or 1e-5 of them), none by more than 100
    times; integer leaves exact. -> {ok, bit_equal, the worst tensor and
    its largest difference over its tolerance, the elements over}."""
    ok, bit_equal, worst, n_over_all = True, True, ("", 0.0), 0

    def walk(g, w, name):
        nonlocal ok, bit_equal, worst, n_over_all
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{name}.{k}" if name else k)
            return
        if not isinstance(w, torch.Tensor) or not w.is_floating_point():
            same = (torch.equal(g, w) if isinstance(w, torch.Tensor)
                    else g == w)
            ok, bit_equal = ok and same, bit_equal and same
            return
        bit_equal = bit_equal and torch.equal(g, w)
        diff = (g.double() - w.double()).abs()
        tol = ADAM_ATOL + ADAM_SCALE_RTOL * float(w.abs().max())
        n_over = int((diff > tol).sum())
        n_over_all += n_over
        ratio = float(diff.max()) / tol if diff.numel() else 0.0
        worst = max(worst, (name, ratio), key=lambda t: t[1])
        ok = ok and n_over <= max(4, w.numel() * 1e-5) and ratio <= 100

    walk(got, want, "")
    return dict(ok=ok, bit_equal=bit_equal, worst=worst[0],
                worst_over_tol=worst[1], elements_over_tol=n_over_all)


def _count_collectives():
    """Wrap torch.distributed's all_reduce and broadcast with a counter."""
    import torch.distributed as dist
    counts = {"all_reduce": 0, "broadcast": 0}
    for name in counts:
        plain = getattr(dist, name)

        def counted(*a, _plain=plain, _name=name, **k):
            counts[_name] += 1
            return _plain(*a, **k)

        setattr(dist, name, counted)
    return counts


def _train_steps(step_fn, assets, carry, n):
    """``n`` train steps -> (carry, the last one's metrics as floats)."""
    for _ in range(n):
        carry, m = step_fn(assets, carry)
    return carry, {k: float(v) for k, v in m.items()}


def _w1_sac(mesh, assets, dev):
    """Two train steps of the shrunk stage-1 SAC recipe (the first warms
    up, the second updates)."""
    from torchdriveenv_tpu_torch.config import construct_rl_training_config
    from torchdriveenv_tpu_torch.parallel.train_step import make_offpolicy_train_fns
    from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    cfg = construct_rl_training_config(copy.deepcopy(_SAC)).env
    agent = SAC(SACConfig(**_SAC["algo_kwargs"]))
    init_fn, step_fn = make_offpolicy_train_fns(
        cfg, agent, RECIPE_ENVS, buffer_capacity=W1_SAC_CAPACITY,
        steps_per_iter=RECIPE_STEPS_PER_ITER, updates_per_iter=W1_SAC_UPDATES,
        demo_fn=make_scripted_driver(cfg, assets), demo_steps=RECIPE_DEMO_STEPS,
        demo_envs=RECIPE_DEMO_ENVS, device=dev, mesh=mesh)
    carry = init_fn(assets, RECIPE_SEED)
    carry, metrics = _train_steps(step_fn, assets, carry, 2)
    return agent.export_state(), metrics, carry


def _w1_ppo(mesh, assets, dev):
    from torchdriveenv_tpu_torch.config import construct_rl_training_config
    from torchdriveenv_tpu_torch.parallel.train_step import make_onpolicy_train_fns
    from torchdriveenv_tpu_torch.rl.ppo import PPO, PPOConfig
    cfg = construct_rl_training_config(copy.deepcopy(RECIPES[PPO_YML])).env
    agent = PPO(PPOConfig(**W1_PPO_KW))
    init_fn, step_fn = make_onpolicy_train_fns(cfg, agent, W1_PPO_ENVS,
                                               device=dev, mesh=mesh)
    carry = init_fn(assets, 0)
    carry, metrics = _train_steps(step_fn, assets, carry, 1)
    return agent.export_state(), metrics, carry


def _multi_world1(pm, dev) -> dict:
    """World 1 under nccl (the card) or gloo (a CPU rehearsal): the shrunk
    stage-1 SAC recipe and a PPO train step, first with no process group
    (once to warm up, once for reference), then inside one: a one-rank
    group makes no mesh and issues no collective."""
    import torch.distributed as dist
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    assets = load_assets("train", device=dev)
    steps = (("sac", _w1_sac, RECIPE_ENVS), ("ppo", _w1_ppo, W1_PPO_ENVS))
    # with no process group: a warm-up run (the first pays cuDNN's and the
    # allocator's set-up), then the reference
    for _, fn, _ in steps:
        fn(None, assets, dev)
    ref = {name: fn(None, assets, dev) for name, fn, _ in steps}
    assert pm.maybe_init_distributed(), "WORLD_SIZE=1 did not init"
    counts = _count_collectives()
    out = dict(backend=dist.get_backend(), world=dist.get_world_size())
    for name, fn, n in steps:
        mesh = pm.make_mesh(n)
        assert mesh is None, f"a one-rank group made {mesh}"
        state, metrics, _ = fn(mesh, assets, dev)
        r_state, r_metrics, _ = ref[name]
        out[name] = dict(adam_close(state, r_state),
                         metrics_equal=metrics == r_metrics)
        log(f"[multi world1] {name}: world {out['world']} ({out['backend']}) "
            f"against no process group: bit-equal {out[name]['bit_equal']}, "
            f"within the Adam tolerance {out[name]['ok']}, metrics equal "
            f"{out[name]['metrics_equal']}")
    out["collectives"] = dict(counts)
    return out


def _gathered_rollout(env, state, act, steps, pm, mesh):
    """``steps`` env steps (the rasterizer's host launches counted from 0:
    under a mesh the step is eager, so they are the kernel's runs); then the
    per-step frames, done flags and agent states gathered over the mesh."""
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    rows = []
    rc.render_obs_cuda.launches = 0
    for _ in range(steps):
        out = env.step(state, act)
        state = out.state
        rows.append(dict(obs=out.obs, terminated=out.terminated,
                         truncated=out.truncated,
                         agent_states=state.agent_states,
                         step_idx=state.step_idx, case=state.case))
    launches = rc.render_obs_cuda.launches
    return ([{k: pm.gather_rows(v, mesh) for k, v in r.items()}
             for r in rows], launches)


def _compare_rows(got, want) -> dict:
    """Sharded against one process: done flags and ints exact, agent states
    at atol 1e-4 / rtol 1e-5, frames counted pixel by pixel."""
    exact, states_ok, pixels, max_err = True, True, [], 0.0
    for g, w in zip(got, want):
        for k in ("terminated", "truncated", "step_idx", "case"):
            exact = exact and torch.equal(g[k], w[k])
        d = (g["agent_states"] - w["agent_states"]).abs()
        max_err = max(max_err, float(d.max()))
        states_ok = states_ok and bool(
            (d <= 1e-4 + 1e-5 * w["agent_states"].abs()).all())
        pixels.append(int((g["obs"] != w["obs"]).sum()))
    total = got[0]["obs"].numel()
    return dict(exact=exact, states_ok=states_ok, max_state_err=max_err,
                pixels_apart=pixels, pixels_per_step=total,
                pixels_ok=max(pixels) <= 1e-3 * total)


def _small_learner(kind, mesh, assets, dev, n_envs):
    """(agent, carry, step_fn) of an f32 train step at a small size: SAC
    (64-pixel frames, batches of 128, two updates) or PPO (4 steps per
    rollout, minibatches of 64, two epochs)."""
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.parallel.train_step import (
        make_offpolicy_train_fns, make_onpolicy_train_fns)
    cfg = EnvConfig(max_environment_steps=3)
    if kind == "sac":
        from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
        agent = SAC(SACConfig(batch_size=128, learning_starts=0),
                    compute_dtype=torch.float32)
        init_fn, step_fn = make_offpolicy_train_fns(
            cfg, agent, n_envs, buffer_capacity=16, steps_per_iter=2,
            updates_per_iter=2, device=dev, mesh=mesh)
    else:
        from torchdriveenv_tpu_torch.rl.ppo import PPO, PPOConfig
        agent = PPO(PPOConfig(n_steps=4, batch_size=64, n_epochs=2),
                    compute_dtype=torch.float32)
        init_fn, step_fn = make_onpolicy_train_fns(cfg, agent, n_envs,
                                                   device=dev, mesh=mesh)
    return agent, init_fn(assets, 0), step_fn


def _small_train_step(kind, mesh, assets, dev, n_envs):
    """One small train step -> (agent state after it, metrics, and the
    synchronizing calls of one more step by source line, or None off the
    card)."""
    agent, carry, step_fn = _small_learner(kind, mesh, assets, dev, n_envs)
    carry, metrics = _train_steps(step_fn, assets, carry, 1)
    state = copy.deepcopy(agent.export_state())
    syncs = None
    if torch.device(dev).type == "cuda":
        _, syncs = synchronizing_calls(lambda: step_fn(assets, carry))
    return state, metrics, syncs


def _split_grad_witness(assets, dev, n_envs) -> dict:
    """One process, no collective: does taking a convolution's gradient
    over each rank's rows, then summing, move SAC past the Adam tolerance by
    itself? After one small SAC train step, a 128-row replay batch; the
    critic's loss gradient (its squared error to the batch's rewards) taken
    over all rows, and over the rows of each half of the envs (the two
    ranks' row shapes) then summed; one fresh Adam step of the agent's
    hyperparameters from the same parameters with each. cuDNN on and off."""
    from torchdriveenv_tpu_torch.rl import buffer as replay
    from torchdriveenv_tpu_torch.rl.optim import apply_grads
    out = {}
    for cudnn in (True, False):
        torch.backends.cudnn.enabled = cudnn
        agent, carry, step_fn = _small_learner("sac", None, assets, dev,
                                               n_envs)
        carry, _ = step_fn(assets, carry)
        critic, b = agent.state.critic, agent.cfg.batch_size
        g = torch.Generator(device=dev)
        g.manual_seed(7)
        env_idx = torch.randint(0, n_envs, (b,), generator=g, device=dev)
        off = torch.randint(0, max(int(carry.buffer.filled) - 1, 1), (b,),
                            generator=g, device=dev)
        batch = replay.sample(carry.buffer, b, 3, indices=(env_idx, off))
        halves = [torch.nonzero(env_idx < n_envs // 2)[:, 0],
                  torch.nonzero(env_idx >= n_envs // 2)[:, 0]]
        params = list(critic.parameters())

        def grads(rows):
            q1, q2 = critic(batch["obs"][rows], batch["action"][rows])
            y = batch["reward"][rows]
            loss = ((q1 - y) ** 2 + (q2 - y) ** 2).sum() / b
            return torch.autograd.grad(loss, params)

        whole = grads(torch.arange(b, device=dev))
        split = [x + y for x, y in zip(grads(halves[0]), grads(halves[1]))]
        hyper = {k: agent.state.critic_opt.param_groups[0][k]
                 for k in ("lr", "betas", "eps")}

        def adam_step(gs):
            ps = [p.detach().clone().requires_grad_() for p in params]
            apply_grads(torch.optim.Adam(ps, **hyper), ps, gs)
            return {n: p.detach() for (n, _), p in
                    zip(critic.named_parameters(), ps)}

        grad_err = max(float((x - y).abs().max()) for x, y in zip(split, whole))
        out["cudnn" if cudnn else "no_cudnn"] = dict(
            adam_close(adam_step(split), adam_step(whole)),
            rows=[int(h.numel()) for h in halves], max_grad_diff=grad_err)
    torch.backends.cudnn.enabled = True
    return out


def _flat_floats(tree) -> torch.Tensor:
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        elif isinstance(t, torch.Tensor):
            out.append(t.detach().double().reshape(-1))
    walk(tree)
    return torch.cat(out)


def _multi_world2(pm, dev, n_envs=MULTI_ENVS, steps=MULTI_STEPS,
                  small_envs=MULTI_SMALL_ENVS, reset_pool=None) -> dict:
    """World 2 under gloo; on the card both ranks share the one device.
    ``reset_pool``: the EnvConfig default unless given."""
    import torch.distributed as dist
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env.batched import BatchedEnv
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    assert pm.maybe_init_distributed(backend="gloo", timeout_s=MULTI_TIMEOUT_S)
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = pm.make_mesh(n_envs)
    assets = load_assets("train", device=dev)
    cfg = EnvConfig() if reset_pool is None else EnvConfig(reset_pool=reset_pool)
    out = dict(backend=dist.get_backend(), world=world, envs=n_envs,
               envs_per_rank=mesh.local_envs, steps=steps)

    def per_rank(x: float) -> list:
        v = torch.zeros(world, dtype=torch.float64)
        v[rank] = x
        pm.all_reduce_([v], mesh)
        return v.tolist()

    # ---- a. the route-mode rollout through the kernel
    env = BatchedEnv(cfg, assets, n_envs, device=dev, seed=0, mesh=mesh)
    state, _ = env.reset()
    act = torch.tensor([[0.3, 0.02]], device=dev).repeat(mesh.local_envs, 1)
    got, launches = _gathered_rollout(env, state, act, steps, pm, mesh)
    out["launches"] = [int(x) for x in per_rank(launches)]
    out["done"] = int(sum(int((r["terminated"] | r["truncated"]).sum())
                          for r in got))
    # ---- b. one pooled-reset step with most envs done, unevenly split:
    # every second env of rank 0's half, every eighth of rank 1's
    g_idx = torch.arange(n_envs, device=dev)
    ends = torch.where(g_idx < n_envs // 2, g_idx % 2 == 0, g_idx % 8 == 0)
    pool_env = BatchedEnv(cfg, assets, n_envs, device=dev, seed=1, mesh=mesh)
    pstate, _ = pool_env.reset()
    last = torch.where(ends, cfg.max_environment_steps - 1, 0).to(torch.int32)
    pstate = pstate.replace(step_idx=pm.env_rows(last, mesh))
    pgot, _ = _gathered_rollout(pool_env, pstate, act, 1, pm, mesh)
    # ---- c. one SAC and one PPO train step: parameters equal on the ranks.
    # cuDNN is off here and in the reference: its convolution algorithms
    # differ by batch shape (a rank's ~64 rows against 128), which SAC's
    # Adam turns into steps past the tolerance (the witness below)
    torch.backends.cudnn.enabled = False
    small = {}
    for kind in ("sac", "ppo"):
        state_k, metrics, syncs = _small_train_step(
            kind, pm.make_mesh(small_envs), assets, dev, small_envs)
        flat = _flat_floats(state_k).to(dev)
        first = flat.clone()
        dist.broadcast(first, src=0)
        small[kind] = dict(
            state=state_k, metrics=metrics, syncs=syncs,
            ranks_equal=all(x == 1.0 for x in per_rank(
                float(torch.equal(flat, first)))))
    torch.backends.cudnn.enabled = True
    del first, flat
    if rank != 0:
        return out
    # ---- the one-process references, on rank 0 alone (no collective)
    ref_env = BatchedEnv(cfg, assets, n_envs, device=dev, seed=0)
    ref_state, _ = ref_env.reset()
    ref_act = act[:1].repeat(n_envs, 1)
    want, ref_launches = _gathered_rollout(
        ref_env, ref_state, ref_act, steps, pm, None)
    out["rollout"] = _compare_rows(got, want)
    out["one_process_host_launches"] = ref_launches
    ref_pool = BatchedEnv(cfg, assets, n_envs, device=dev, seed=1)
    rpstate, _ = ref_pool.reset()
    rpstate = rpstate.replace(step_idx=last)
    pwant, _ = _gathered_rollout(ref_pool, rpstate, ref_act, 1, pm, None)
    done = pwant[0]["terminated"] | pwant[0]["truncated"]
    out["pooled"] = dict(_compare_rows(pgot, pwant), pool=cfg.reset_pool,
                         done=int(done.sum()),
                         done_rank0=int(done[:n_envs // 2].sum()),
                         done_rank1=int(done[n_envs // 2:].sum()))
    torch.backends.cudnn.enabled = False
    for kind, s in small.items():
        r_state, r_metrics, r_syncs = _small_train_step(
            kind, None, assets, dev, small_envs)
        out[kind] = dict(
            adam_close(s["state"], r_state), ranks_equal=s["ranks_equal"],
            envs=small_envs,
            syncs=s["syncs"], one_process_syncs=r_syncs,
            metrics={k: [s["metrics"][k], r_metrics[k]] for k in r_metrics})
    torch.backends.cudnn.enabled = True
    out["split_grad_witness"] = _split_grad_witness(assets, dev, small_envs)
    return out


def multi_worker(args) -> int:
    """A rank or one process of the [multi] or --cards phases:
    ``--multi-worker <case> <out_dir> [arguments]``, with RANK / WORLD_SIZE
    / LOCAL_RANK / MASTER_ADDR / MASTER_PORT set for a rank."""
    import torch.distributed as dist
    from torchdriveenv_tpu_torch.parallel import mesh as pm
    from torchdriveenv_tpu_torch.utils.precision import set_f32_precision
    case, out_dir, rest = args[0], args[1], args[2:]
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    set_f32_precision()
    if case.startswith("cards"):
        return _cards_worker(case, out_dir, rest)
    if case.startswith("drift"):
        # the port's precision as a user runs it: cuDNN on (off only in
        # the yardstick's second run), its default algorithms
        torch.backends.cudnn.enabled = case != "drift1_off"
        mesh, name = None, case
        if case == "drift2":
            assert pm.maybe_init_distributed(backend="gloo",
                                             timeout_s=MULTI_TIMEOUT_S)
            mesh = pm.make_mesh(DRIFT_ENVS)
            name = f"drift2_rank{dist.get_rank()}"
        res = _drift_run(mesh, dev)
        if pm.is_main(mesh):
            torch.save(res, os.path.join(out_dir, f"{name}.pt"))
        if mesh is not None:
            dist.destroy_process_group()
        return 0
    torch.backends.cudnn.deterministic = True
    res = (_multi_world1(pm, dev) if case == "world1"
           else _multi_world2(pm, dev))
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, f"{case}.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def launch(phase: str, jobs: list, timeout: float = MULTI_TIMEOUT_S) -> list:
    """Start every job at once, each ``--multi-worker <arguments>`` of this
    script: ``jobs`` is [(label, [arguments], {environment})]. Each writes
    to its own file. All are killed when one fails (its peers would wait
    in a collective until the process group's timeout) or when ``timeout``
    s have passed, and the phase fails. Log the end of each output and
    fail on a non-zero exit. -> each job's output."""
    import subprocess
    base = {k: v for k, v in os.environ.items() if k not in _LAUNCH_VARS}
    with tempfile.TemporaryDirectory() as logs:
        procs, files = [], []
        for i, (_, args, env) in enumerate(jobs):
            files.append(open(os.path.join(logs, f"{i}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--multi-worker",
                 *args], env=dict(base, **env), stdout=files[-1],
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.poll() for p in procs)):
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            outs = []
            for f in files:
                f.seek(0)
                outs.append(f.read())
                f.close()
            for (label, _, _), text in zip(jobs, outs):
                lines = [ln for ln in text.splitlines()
                         if "warn_or_error_on_sync" not in ln]
                for line in lines[-40:]:
                    log(f"[{phase} {label}] {line}")
    for (label, _, _), p in zip(jobs, procs):
        check(p.returncode == 0, f"[{phase}] {label} exited {p.returncode}"
              " (killed: a peer failed or the time ran out)"
              if p.returncode == -9 else
              f"[{phase}] {label} exited {p.returncode}")
    return outs


def run_ranks(phase: str, case: str, world: int, out_dir: str,
              local_is_rank: bool = False, timeout: float = MULTI_TIMEOUT_S
              ) -> list:
    """Run ``world`` ranks of ``--multi-worker <case> <out_dir>`` with
    torchrun's variables (RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR /
    MASTER_PORT): LOCAL_RANK 0 (every rank on the first card) or, with
    ``local_is_rank``, the rank's own card. -> each rank's output."""
    env = dict(WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    return launch(phase, [
        (f"{case} rank {r}", [case, out_dir],
         dict(env, RANK=str(r), LOCAL_RANK=str(r if local_is_rank else 0)))
        for r in range(world)], timeout)


# ---- [multi]'s drift case: a sharded SAC run over 200 train steps ---------
DRIFT_ENVS = 64            # 32 per rank
DRIFT_CAPACITY = 256       # ring cells per env
DRIFT_UPDATES, DRIFT_BATCH = 2, 128
DRIFT_STEPS = 200
DRIFT_MARKS = (1, 2, 5, 10, 20, 50, 100, 150, 200)
# the bound stated in PERF.md (§2 and §6): at every mark the sharded
# run's relative distance from one process is at most this multiple of the
# yardstick's (one process with cuDNN on against one with cuDNN off). The
# early marks give it its reach: at step 200 every departure has grown to
# the same size (ranks that skip the gradient all-reduce read 11 at step
# 2 and 1.4 at step 200; PERF.md §6)
DRIFT_BOUND = 3.0


def _drift_run(mesh, dev) -> dict:
    """DRIFT_STEPS train steps of the stage-1 SAC recipe shrunk to
    DRIFT_ENVS envs, DRIFT_CAPACITY ring cells per env and DRIFT_UPDATES
    updates of DRIFT_BATCH per train step, at the port's precision (the
    recipe's bf16 torso; cuDNN as the caller set it) -> each step's critic
    and actor loss, and the critic's parameters at DRIFT_MARKS, on the
    host. The recipe freezes its actor (``actor_delay_updates``), so the
    critic is what trains."""
    from torchdriveenv_tpu_torch.config import construct_rl_training_config
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.parallel.train_step import make_offpolicy_train_fns
    from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    assets = load_assets("train", device=dev)
    cfg = construct_rl_training_config(copy.deepcopy(_SAC)).env
    agent = SAC(SACConfig(**dict(_SAC["algo_kwargs"], batch_size=DRIFT_BATCH)))
    init_fn, step_fn = make_offpolicy_train_fns(
        cfg, agent, DRIFT_ENVS, buffer_capacity=DRIFT_CAPACITY,
        steps_per_iter=RECIPE_STEPS_PER_ITER, updates_per_iter=DRIFT_UPDATES,
        demo_fn=make_scripted_driver(cfg, assets), demo_steps=RECIPE_DEMO_STEPS,
        demo_envs=RECIPE_DEMO_ENVS, device=dev, mesh=mesh)
    carry = init_fn(assets, RECIPE_SEED)
    losses, marks = [], {}
    t0 = time.perf_counter()
    for step in range(1, DRIFT_STEPS + 1):
        carry, m = step_fn(assets, carry)
        losses.append(torch.stack([m["critic_loss"], m["actor_loss"]]))
        if step in DRIFT_MARKS:
            marks[step] = torch.cat([
                p.detach().float().reshape(-1)
                for p in agent.state.critic.parameters()]).cpu()
    return dict(losses=torch.stack(losses).float().cpu(), marks=marks,
                wall_s=time.perf_counter() - t0,
                cudnn=torch.backends.cudnn.enabled)


def drift_report(sharded: dict, on: dict, off: dict) -> dict:
    """The three curves against one process (cuDNN on) at DRIFT_MARKS: the
    critic's relative parameter distance, and the relative gaps of the
    critic and actor losses; for the two gloo ranks and for the yardstick
    (one process with cuDNN off)."""
    def distance(a, b):
        return float((a.double() - b.double()).norm() / b.double().norm())

    def gaps(a, b):      # (steps, 2): critic, actor
        return ((a["losses"] - b["losses"]).abs()
                / b["losses"].abs().clamp_min(1e-12))

    out = {}
    for label, run in (("sharded", sharded), ("yardstick", off)):
        g = gaps(run, on)
        out[label] = dict(
            distance={s: distance(run["marks"][s], on["marks"][s])
                      for s in DRIFT_MARKS},
            critic_loss_gap={s: float(g[s - 1, 0]) for s in DRIFT_MARKS},
            actor_loss_gap={s: float(g[s - 1, 1]) for s in DRIFT_MARKS},
            max_critic_loss_gap=float(g[:, 0].max()),
            max_actor_loss_gap=float(g[:, 1].max()), wall_s=run["wall_s"])
    out["losses"] = {s: on["losses"][s - 1].tolist() for s in DRIFT_MARKS}
    out["finite"] = all(bool(torch.isfinite(r["losses"]).all())
                        for r in (sharded, on, off))
    out["ratios"] = {s: out["sharded"]["distance"][s] / y
                     for s, y in out["yardstick"]["distance"].items() if y}
    out["ratio"] = max(out["ratios"].values())
    out["bound"] = DRIFT_BOUND
    return out


def multi_phase(card) -> dict:
    """Phase 9: data parallelism. World 1 under nccl must equal the run
    with no process group; world 2 under gloo, both ranks on the one card,
    must equal one process on the 4096-env rollout, a pooled-reset step and
    small SAC / PPO train steps. Each case runs in subprocesses with a
    timeout; any failure fails the phase."""
    def run(case, world, tmp):
        t0 = time.perf_counter()
        outs = run_ranks("multi", case, world, tmp)
        with open(os.path.join(tmp, f"{case}.json")) as f:
            res = json.load(f)
        res["wall_s"] = time.perf_counter() - t0
        # synchronizations reported by threads Python does not see (gloo's
        # workers, which copy CUDA tensors through the host), per rank
        res["thread_syncs"] = [t.count("warn_or_error_on_sync") for t in outs]
        return res

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        w1 = run("world1", 1, tmp)
        w2 = run("world2", 2, tmp)
        drift = drift_case(tmp, card)

    log(f"[multi] world 1 ({w1['backend']}): collectives issued "
        f"{w1['collectives']} [{card}]")
    check(w1["backend"] == "nccl" and w1["world"] == 1,
          f"world 1 ran under {w1['backend']}")
    check(sum(w1["collectives"].values()) == 0,
          f"a one-rank mesh issued collectives: {w1['collectives']}")
    for k in ("sac", "ppo"):
        check(w1[k]["ok"] and w1[k]["metrics_equal"],
              f"world 1 {k} differs from the run with no process group: "
              f"{w1[k]}")
    ro, po = w2["rollout"], w2["pooled"]
    log(f"[multi] world 2 (gloo, both ranks on one card): {w2['envs']} envs, "
        f"{w2['envs_per_rank']} per rank, {w2['steps']} steps: done flags "
        f"exact {ro['exact']}, max state error {ro['max_state_err']:.3e}, "
        f"pixels apart per step {ro['pixels_apart']} of {ro['pixels_per_step']}"
        f"; {w2['done']} episodes ended; kernel launches per rank "
        f"{w2['launches']} [{card}]")
    log(f"[multi] pooled step: pool {po['pool']}, done {po['done']} "
        f"({po['done_rank0']} on rank 0, {po['done_rank1']} on rank 1), "
        f"exact {po['exact']}, max state error {po['max_state_err']:.3e}, "
        f"pixels apart {po['pixels_apart']}")
    for k in ("sac", "ppo"):
        log(f"[multi] world 2 {k} train step ({w2[k]['envs']} envs, f32, "
            f"cuDNN off): ranks equal {w2[k]['ranks_equal']}, within the "
            f"Adam tolerance of one process {w2[k]['ok']} "
            f"({w2[k]['elements_over_tol']} elements over it; worst "
            f"{w2[k]['worst']} at {w2[k]['worst_over_tol']:.3f} of its "
            f"tolerance); synchronizing calls in the next train step, rank 0 "
            f"{w2[k]['syncs']}, one process {w2[k]['one_process_syncs']}")
    log(f"[multi] world 2: synchronizations outside Python's threads in "
        f"those two counted train steps (gloo's workers), per rank "
        f"{w2['thread_syncs']}")
    for k, v in w2["split_grad_witness"].items():
        log(f"[multi] one-process witness ({k}): SAC critic gradient over "
            f"rows {v['rows']} summed against all 128, max difference "
            f"{v['max_grad_diff']:.3e}; after one Adam step "
            f"{v['elements_over_tol']} elements over the Adam tolerance, "
            f"worst {v['worst']} at {v['worst_over_tol']:.3f} of it")
    check(w2["backend"] == "gloo" and w2["world"] == 2, "world 2 set-up")
    check(ro["exact"] and ro["states_ok"] and ro["pixels_ok"],
          f"the sharded rollout differs from one process: {ro}")
    check(all(n == MULTI_STEPS for n in w2["launches"]),
          f"kernel launches per rank {w2['launches']}, not one per step")
    check(po["exact"] and po["states_ok"] and po["pixels_ok"]
          and po["done"] > po["pool"] and po["done_rank0"] > po["done_rank1"],
          f"the pooled-reset step differs from one process: {po}")
    for k in ("sac", "ppo"):
        check(w2[k]["ranks_equal"], f"world 2 {k}: the ranks differ")
        check(w2[k]["ok"], f"world 2 {k} train step: {w2[k]}")
        check(not w2[k]["one_process_syncs"],
              f"one process {k} train step synchronized: "
              f"{w2[k]['one_process_syncs']}")
    return dict(world1=w1, world2=w2, drift=drift)


def drift_case(tmp: str, card: str) -> dict:
    """[multi]'s drift case: two gloo ranks on the card and two single
    processes (cuDNN on, the reference; cuDNN off, the yardstick), all four
    started together, each taking DRIFT_STEPS train steps of the shrunk
    stage-1 SAC recipe; the sharded run's distance from one process held
    to DRIFT_BOUND times the yardstick's at every mark."""
    t0 = time.perf_counter()
    env = dict(WORLD_SIZE="2", LOCAL_RANK="0", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()))
    launch("multi", [(f"drift2 rank {r}", ["drift2", tmp],
                      dict(env, RANK=str(r))) for r in range(2)]
           + [(case, [case, tmp], {}) for case in ("drift1_on", "drift1_off")])
    runs = {k: torch.load(os.path.join(tmp, f"{k}.pt"), weights_only=False)
            for k in ("drift2_rank0", "drift1_on", "drift1_off")}
    rep = drift_report(runs["drift2_rank0"], runs["drift1_on"],
                       runs["drift1_off"])
    rep["wall_s"] = time.perf_counter() - t0
    last = DRIFT_MARKS[-1]
    for label in ("sharded", "yardstick"):
        r = rep[label]
        log(f"[multi] drift, {label} against one process (cuDNN on), "
            f"{DRIFT_ENVS} envs, {DRIFT_STEPS} train steps of "
            f"{DRIFT_UPDATES} updates of {DRIFT_BATCH}: critic's relative "
            "distance " + ", ".join(f"{s}: {v:.3e}" for s, v in
                                   r["distance"].items())
            + "; critic loss gap " + ", ".join(
                f"{s}: {v:.2e}" for s, v in r["critic_loss_gap"].items())
            + "; actor loss gap " + ", ".join(
                f"{s}: {v:.2e}" for s, v in r["actor_loss_gap"].items())
            + f"; run {r['wall_s']:.1f} s [{card}]")
    log(f"[multi] drift: losses of one process (critic, actor) "
        + ", ".join(f"{s}: {v[0]:.4g} / {v[1]:.4g}"
                    for s, v in rep["losses"].items()))
    log(f"[multi] drift at step {last}: sharded {rep['sharded']['distance'][last]:.3e}"
        f", yardstick {rep['yardstick']['distance'][last]:.3e}; the sharded "
        "distance over the yardstick's " + ", ".join(
            f"{s}: {v:.3f}" for s, v in rep["ratios"].items())
        + f", at most {rep['ratio']:.3f}, bound {DRIFT_BOUND} (PERF.md); "
        f"case {rep['wall_s']:.1f} s")
    check(rep["finite"], "drift: a non-finite loss")
    check(rep["ratio"] <= DRIFT_BOUND,
          f"drift: the sharded distance reaches {rep['ratio']:.3f} times the "
          f"yardstick's, over the bound {DRIFT_BOUND}")
    return rep


# ---- --cards 4: the training CLI data parallel over four cards -----------
# its ranks and its one-process runs are subprocesses of this script, each
# rank on its own card (LOCAL_RANK = RANK) under nccl
CARDS = 4
CARDS_BACKEND = "nccl"
CARDS_TIMEOUT_S = 900       # per stage
CARD_TRAIN_STEPS = 3        # train steps of every run
CARD_RESUME_AT = 2          # the snapshot resumed for the last train step
CARD_WIDE_ENVS = 4096       # ppo_1024.yml with parallel_env_num overridden
# run -> (recipe, global envs, held to one process in f32 with cuDNN off;
# the others run at the recipe's precision)
CARD_RUNS = {
    "ppo_wide": (PPO_YML, CARD_WIDE_ENVS, True),
    "ppo": (PPO_YML, RECIPES[PPO_YML]["parallel_env_num"], True),
    "sac": (SAC_YML, RECIPE_ENVS, True),
    "ppo_wide_recipe": (PPO_YML, CARD_WIDE_ENVS, False),
    "ppo_per_card_recipe": (PPO_YML, CARD_WIDE_ENVS * CARDS, False),
    "sac_recipe": (SAC_YML, RECIPE_ENVS, False),
}
CARD_SNAPSHOT_RUNS = ("ppo", "sac")     # resumed at CARD_RESUME_AT
# the Adam-parity tolerance is held where the CPU tests hold it: after each
# of a parity run's first gradient updates from one state (later updates
# compound the rounding of other summation orders; PERF.md §6)
CARD_PARITY_UPDATES = 3
# ... and after the whole first updating train step, world CARDS's worst
# element is at most this multiple of the worst of one process whose
# batches only have their rows reordered (the same order of magnitude)
CARD_WITNESS_ORDER = 10.0
# stage B: every rank, in order
CARD_MESH_JOBS = ("ppo_wide", "ppo", "ppo_resumed", "sac", "sac_resumed",
                  "ppo_wide_recipe", "ppo_per_card_recipe", "sac_recipe")
# stage C: one process a card, the cards' jobs side by side (the resumed
# runs read stage B's snapshots)
CARD_ONE_JOBS = (("ppo_wide",), ("ppo", "ppo_resumed"),
                 ("sac", "sac_resumed", "sac_order"), ("ppo_order",))


def _card_steps_per_iter(recipe: str, envs: int) -> int:
    raw = RECIPES[recipe]
    if raw["algorithm"] == "ppo":
        return envs * raw["algo_kwargs"]["n_steps"]
    return envs * raw["offpolicy_steps_per_iter"]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


def carry_close(got: dict, want: dict) -> dict:
    """Two ``full_latest`` trees (as ``carry_to_tree`` makes them, on the
    host): the agents at the Adam-parity tolerance, the step count and the
    generator exact, env rows as [multi] holds them (ints and bools exact,
    floats atol 1e-4 / rtol 1e-5, uint8 frames at most a 1e-3 share
    apart)."""
    agent = adam_close(got["agent"], want["agent"])
    same = (got["env_steps"] == want["env_steps"]
            and torch.equal(got["generator"], want["generator"]))
    bit_equal, envs_ok, worst, share = agent["bit_equal"] and same, True, 0.0, 0.0
    for key in ("env_state", "obs_stack", "buffer"):
        if key not in want:
            continue
        g_leaves = dict(_leaves(got[key]))
        for name, w in _leaves(want[key]):
            g = g_leaves[name]
            if not isinstance(w, torch.Tensor):
                envs_ok = envs_ok and g == w
                continue
            eq = torch.equal(g, w)
            bit_equal = bit_equal and eq
            if eq:
                continue
            if w.dtype == torch.uint8:
                share = max(share, float((g != w).float().mean()))
            elif w.is_floating_point():
                d = (g.double() - w.double()).abs()
                worst = max(worst, float(d.max()))
                envs_ok = envs_ok and bool(
                    (d <= 1e-4 + 1e-5 * w.double().abs()).all())
            else:
                envs_ok = False
    envs_ok = envs_ok and share <= 1e-3
    return dict(ok=agent["ok"] and same and envs_ok, bit_equal=bit_equal,
                agent=agent, same_step_and_generator=same, envs_ok=envs_ok,
                max_state_err=worst, pixel_share=share)


def _card_job(job: str, out_dir: str, world: int) -> dict:
    """One run of the training CLI's ``train`` (``rl/train.py``) in this
    process: ``job`` is a CARD_RUNS key, or ``<run>_resumed`` (that run
    resumed from the world-4 snapshot at CARD_RESUME_AT for its last train
    step, held to the world-4 run without a break). Writes under
    ``<out_dir>/w<world>/<job>``; a ``model_*`` after every train step,
    ``full_latest`` at CARD_RESUME_AT and at the end in a world-4 run of
    CARD_SNAPSHOT_RUNS (each renamed ``full_latest_<env steps>``), the
    recipe's evaluation once after the first train step, with video in
    ``ppo_wide``. Parity runs are f32 with cuDNN off. -> per train step:
    host launches, rendered batch sizes, the host clock's start and end,
    metrics; what this process saved, its peak memory, whether the ranks'
    agents are equal, and the resumed carry against the run without a
    break."""
    import torch.distributed as dist
    from torchdriveenv_tpu_torch import config as tconfig
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    from torchdriveenv_tpu_torch.parallel import mesh as pm
    from torchdriveenv_tpu_torch.rl import train as train_mod
    run = job[:-len("_resumed")] if job.endswith("_resumed") else job
    resumed = run != job
    recipe, envs, parity = CARD_RUNS[run]
    spi = _card_steps_per_iter(recipe, envs)
    w4 = os.path.join(out_dir, f"w{CARDS}", run, "ckpt")
    here = os.path.join(out_dir, f"w{world}", job)
    raw = copy.deepcopy(RECIPES[recipe])
    snapshots = world > 1 and run in CARD_SNAPSHOT_RUNS and not resumed
    raw.update(parallel_env_num=envs, total_timesteps=CARD_TRAIN_STEPS * spi,
               log_dir=os.path.join(here, "runs"),
               checkpoint_dir=os.path.join(here, "ckpt"),
               full_snapshot_every=CARD_RESUME_AT * spi if snapshots else -1)
    raw["wandb_callback"]["model_save_freq"] = spi
    raw["eval_val_callback"].update(n_steps=10 ** 9, record=job == "ppo_wide")
    raw["eval_train_callback"].update(n_steps=10 ** 9)
    cfg = tconfig.construct_rl_training_config(raw)
    torch.backends.cudnn.enabled = not parity
    torch.backends.cudnn.deterministic = parity
    dev = torch.device("cuda", torch.cuda.current_device())

    saved, renders = [], []
    plain_build, plain_save = train_mod.build_agent, train_mod._save
    plain_launch = rc._launch
    main = not dist.is_initialized() or dist.get_rank() == 0

    def build(*a, **k):
        agent, on_policy = plain_build(*a, **k)
        if parity:
            agent.compute_dtype = torch.float32
            _snapshot_updates(agent, "_step" if on_policy else "update",
                              lambda: len(probe.rows) + 1, here, main)
        return agent, on_policy

    def save(ckpt_dir, name, tree):
        path = plain_save(ckpt_dir, name, tree)
        saved.append(name)
        if name == "full_latest":
            os.replace(path, f"{path}_{tree['env_steps']}")
        return path

    def launch_(maps, town, *a, **k):
        renders.append((time.perf_counter(), int(town.shape[0])))
        return plain_launch(maps, town, *a, **k)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resume_from = (os.path.join(w4, f"full_latest_{CARD_RESUME_AT * spi}")
                   if resumed else None)
    with probed_train(train_mod, rc) as probe:
        train_mod.build_agent, train_mod._save = build, save
        rc._launch = launch_
        try:
            t0 = time.perf_counter()
            carry = train_mod.train(cfg, resume_from=resume_from)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            train_mod.build_agent, train_mod._save = plain_build, plain_save
            rc._launch = plain_launch
    rows = [dict(r, render_batches=sorted(
                {b for t, b in renders
                 if r["host_start"] <= t <= r["host_end"]}),
                 metrics={k: float(v) for k, v in m.items()})
            for r, m in zip(probe.rows, probe.metrics)]
    mesh = pm.make_mesh(envs)
    out = dict(job=job, world=world, envs=envs, steps_per_iter=spi,
               local_envs=mesh.local_envs if mesh else envs, parity=parity,
               rows=rows, wall_s=wall, saved=saved,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               card=torch.cuda.current_device(),
               card_gb=torch.cuda.get_device_properties(dev).total_memory / 1e9)
    if hasattr(carry, "buffer"):
        out["ring_gb"] = carry.buffer.frames.numel() / 1e9
    if mesh is not None:
        state = _flat_floats(probe.agent.export_state()).to(dev)
        first = state.clone()
        dist.broadcast(first, src=0)
        same = torch.tensor([int(torch.equal(state, first))], device=dev)
        dist.all_reduce(same)
        out["ranks_equal"] = int(same.item()) == mesh.world
    if resumed:
        tree = _on(train_mod.carry_to_tree(carry, probe.agent, mesh), "cpu")
        if pm.is_main(mesh):
            want = torch.load(
                os.path.join(w4, f"full_latest_{CARD_TRAIN_STEPS * spi}"),
                weights_only=True, map_location="cpu", mmap=True)
            out["against_unbroken"] = carry_close(tree, want)
        del tree
    del carry
    return out


def _snapshot_updates(agent, name: str, train_step, here: str, main: bool):
    """Wrap the agent's gradient update ``name`` (PPO's ``_step``, SAC's
    ``update``): after each of the first CARD_PARITY_UPDATES of every
    train step (``train_step()`` its number in the run), the main process
    writes the agent's state to ``<here>/update_<train step>_<k>.pt``."""
    plain, seen = getattr(agent, name), {}

    def stepped(*a, **k):
        out = plain(*a, **k)
        step = train_step()
        seen[step] = seen.get(step, 0) + 1
        if main and seen[step] <= CARD_PARITY_UPDATES:
            os.makedirs(here, exist_ok=True)
            torch.save(_on(agent.export_state(), "cpu"),
                       os.path.join(here, f"update_{step}_{seen[step]}.pt"))
        return out

    setattr(agent, name, stepped)


def _ppo_order_witness() -> dict:
    """One process, f32 with cuDNN off: the first PPO update of ppo_wide's
    recipe (4 epochs of 16 minibatches of 8192 rows of 4096 envs x 32
    steps) taken twice from one state on one rollout and the same
    minibatches, the rows of each minibatch in two orders: the same sums,
    added in another order. -> the two agents at the Adam-parity tolerance
    after each of the first CARD_PARITY_UPDATES gradient steps and after
    the whole update."""
    from torchdriveenv_tpu_torch.config import construct_rl_training_config
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.parallel.train_step import make_onpolicy_train_fns
    from torchdriveenv_tpu_torch.rl.ppo import PPO, PPOConfig
    recipe, envs, _ = CARD_RUNS["ppo_wide"]
    raw = copy.deepcopy(RECIPES[recipe])
    kw = raw["algo_kwargs"]
    cfg = construct_rl_training_config(raw).env
    torch.backends.cudnn.enabled = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", torch.cuda.current_device())
    assets = load_assets("train", device=dev)
    agent = PPO(PPOConfig(**kw), compute_dtype=torch.float32)
    init_fn, step_fn = make_onpolicy_train_fns(cfg, agent, envs, device=dev)
    carry = init_fn(assets, 0)
    got = {}

    def capture(rollout, last_value, **_):      # the rollout, no update
        got.update(rollout=rollout, last_value=last_value,
                   start=copy.deepcopy(agent.export_state()))
        return {k: torch.zeros((), device=dev) for k in agent.metric_names}

    agent.update = capture
    step_fn(assets, carry)
    del agent.update
    n, m = kw["n_steps"] * envs, kw["batch_size"]
    g = torch.Generator().manual_seed(0)
    perms = torch.stack([torch.randperm(n, generator=g)
                         for _ in range(kw["n_epochs"])])
    reordered = perms.clone()
    for e in range(kw["n_epochs"]):
        for lo in range(0, n - m + 1, m):
            reordered[e, lo:lo + m] = perms[e, lo:lo + m][
                torch.randperm(m, generator=g)]
    out = {}
    for label, p in (("first", perms), ("reordered", reordered)):
        agent.load_state(got["start"])
        with tempfile.TemporaryDirectory() as d:
            _snapshot_updates(agent, "_step", lambda: 1, d, True)
            agent.update(got["rollout"], got["last_value"], perms=p.to(dev))
            del agent._step
            out[label] = ([torch.load(os.path.join(d, f"update_1_{k}.pt"))
                           for k in range(1, CARD_PARITY_UPDATES + 1)],
                          _on(agent.export_state(), "cpu"))
    return _witness_report(out, kw["n_epochs"] * (n // m))


def _witness_report(out: dict, steps: int) -> dict:
    (a, whole_a), (b, whole_b) = out["first"], out["reordered"]
    return dict(updates=[adam_close(y, x) for x, y in zip(a, b)],
                whole=adam_close(whole_b, whole_a), gradient_steps=steps)


def _sac_order_witness() -> dict:
    """One process, f32 with cuDNN off: the stage-1 SAC recipe (CARD_RUNS'
    ``sac``: 128 envs, a 3125-cell ring) up to its first train step with
    gradient updates, whose RECIPE_UPDATES_PER_ITER sampled batches and
    noise draws are kept; those updates then taken twice from one state,
    the second time with each batch's rows (and their places in the
    global batch, which index the noise) in another order: the same sums,
    added in another order. -> the two agents at the Adam-parity tolerance
    after each of the first CARD_PARITY_UPDATES updates and after all of
    them."""
    from torchdriveenv_tpu_torch.config import construct_rl_training_config
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.parallel.train_step import make_offpolicy_train_fns
    from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    recipe, envs, _ = CARD_RUNS["sac"]
    raw = copy.deepcopy(RECIPES[recipe])
    kw = raw["algo_kwargs"]
    cfg = construct_rl_training_config(raw).env
    torch.backends.cudnn.enabled = False
    torch.backends.cudnn.deterministic = True
    dev = torch.device("cuda", torch.cuda.current_device())
    assets = load_assets("train", device=dev)
    agent = SAC(SACConfig(**kw), compute_dtype=torch.float32)
    init_fn, step_fn = make_offpolicy_train_fns(
        cfg, agent, envs, buffer_capacity=kw["buffer_size"] // envs,
        steps_per_iter=raw["offpolicy_steps_per_iter"],
        updates_per_iter=raw["offpolicy_updates_per_iter"],
        demo_fn=make_scripted_driver(cfg, assets),
        demo_steps=raw["demo_warmup_steps"], demo_envs=raw["demo_envs"],
        device=dev)
    carry = init_fn(assets, raw["env"]["seed"])
    got = []

    def capture(batch, generator=None, mesh=None):
        # the two noise draws update() would make, in its order; no update
        shape = batch["action"].shape
        got.append((batch, [torch.randn(shape, generator=generator,
                                        device=dev) for _ in range(2)]))
        return {k: torch.zeros((), device=dev) for k in agent.metric_names}

    agent.update = capture
    while not got:
        start = copy.deepcopy(agent.export_state())
        carry, _ = step_fn(assets, carry)
    del agent.update, carry
    g = torch.Generator().manual_seed(0)
    out = {}
    for label in ("first", "reordered"):
        agent.load_state(start)
        snaps = []
        for batch, noise in got:
            if label == "reordered":
                p = torch.randperm(len(batch["pos"]), generator=g).to(dev)
                batch = {k: v[p] for k, v in batch.items()}
            agent.update(batch, noise=noise)
            if len(snaps) < CARD_PARITY_UPDATES:
                snaps.append(_on(agent.export_state(), "cpu"))
        out[label] = (snaps, _on(agent.export_state(), "cpu"))
    return _witness_report(out, len(got))


def _cards_worker(case: str, out_dir: str, args: list) -> int:
    """``cards_mesh``: a rank of stage B, every job of CARD_MESH_JOBS in
    one process group (LOCAL_RANK is the rank's card); ``cards_one <card>
    <job> ...``: one process on that card, no process group. Each writes
    its results as JSON after every job."""
    import torch.distributed as dist
    from torchdriveenv_tpu_torch.parallel import mesh as pm
    if case == "cards_mesh":
        # as the CLI joins: the backend's default timeout
        assert pm.maybe_init_distributed(backend=CARDS_BACKEND)
        world, jobs = dist.get_world_size(), CARD_MESH_JOBS
        name = f"w{world}_rank{dist.get_rank()}"
    else:
        torch.cuda.set_device(int(args[0]))
        world, jobs = 1, args[1:]
        name = f"w1_card{args[0]}_{'+'.join(jobs)}"
    # the runs' metrics go to their JSONL files; no wandb run a job
    os.environ.setdefault("WANDB_MODE", "disabled")
    log(f"{name}: card {torch.cuda.current_device()} of "
        f"{torch.cuda.device_count()}, LOCAL_RANK "
        f"{os.environ.get('LOCAL_RANK')}")
    results = {}
    for job in jobs:
        if job in ("ppo_order", "sac_order"):
            results[job] = (_ppo_order_witness() if job == "ppo_order"
                            else _sac_order_witness())
            log(f"{name} {job}: {results[job]}")
        else:
            results[job] = r = _card_job(job, out_dir, world)
            log(f"{name} {job}: {len(r['rows'])} train steps, wall "
                f"{r['wall_s']:.1f} s, peak {r['peak_gb']:.2f} GB")
        with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
            json.dump(results, f)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


def _torchrun_cli(out_dir: str) -> dict:
    """The README's command on CARDS cards: ``python -m
    torch.distributed.run --standalone --nproc_per_node 4 -m
    torchdriveenv_tpu_torch.rl.train --config_file ppo_1024.yml
    --parallel_env_num 4096 --total_timesteps <3 train steps>`` from an
    empty directory (its ``runs/`` and ``models/`` land there), at the
    recipe's precision, with its evaluation and video after the first train
    step."""
    import subprocess
    recipe, envs, _ = CARD_RUNS["ppo_wide"]
    total = CARD_TRAIN_STEPS * _card_steps_per_iter(recipe, envs)
    here = os.path.join(out_dir, "torchrun")
    os.makedirs(here)
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_VARS}
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={CARDS}", "-m",
           "torchdriveenv_tpu_torch.rl.train", "--config_file",
           os.path.join(root, recipe), "--parallel_env_num", str(envs),
           "--total_timesteps", str(total)]
    t0 = time.perf_counter()
    with open(os.path.join(here, "out.log"), "w+") as f:
        try:
            rc = subprocess.run(cmd, cwd=here, env=env, stdout=f,
                                stderr=subprocess.STDOUT,
                                timeout=CARDS_TIMEOUT_S).returncode
        finally:
            f.seek(0)
            lines = f.read().splitlines()
    wall = time.perf_counter() - t0
    for line in lines[-30:]:
        log(f"[cards torchrun] {line}")
    check(rc == 0, f"[cards] torchrun exited {rc}")
    (run_dir,) = os.listdir(os.path.join(here, "models"))
    ckpt = sorted(os.listdir(os.path.join(here, "models", run_dir)))
    (jsonl,) = [f for f in os.listdir(os.path.join(here, "runs"))
                if f.endswith(".jsonl")]
    with open(os.path.join(here, "runs", jsonl)) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if "train/loss" in r]
    spi = total // CARD_TRAIN_STEPS
    videos = [f for d, _, fs in os.walk(os.path.join(here, "runs"))
              for f in fs if f.endswith(".avi")]
    return dict(command=" ".join(cmd[1:]), wall_s=wall, checkpoints=ckpt,
                train_records=len(train),
                # the CLI logs every max(1, 1000 // steps per iteration)
                expected_train_records=CARD_TRAIN_STEPS // max(1, 1000 // spi),
                eval_records=sum(any(k.startswith("eval/") for k in r)
                                 for r in records),
                videos=videos, total=total)


def cards_phase(card: str) -> dict:
    """--cards 4. Stage B: CARDS ranks under nccl, each on its card, every
    job of CARD_MESH_JOBS; stage C: the one-process runs, one card each,
    side by side (the parity references, the world-4 snapshots resumed in
    one process, the order witnesses); stage D: the README's torchrun
    command. Then each world-4 run against one process, the resumes
    against the run without a break, the checkpoints and the
    evaluation."""
    tmp = tempfile.mkdtemp(prefix="cards_")
    try:
        t_a = time.perf_counter()
        run_ranks("cards", "cards_mesh", CARDS, tmp, local_is_rank=True,
                  timeout=CARDS_TIMEOUT_S)
        t_b = time.perf_counter()
        launch("cards", [(f"C card {c}", ["cards_one", tmp, str(c), *jobs],
                          {}) for c, jobs in enumerate(CARD_ONE_JOBS)],
               CARDS_TIMEOUT_S)
        t_c = time.perf_counter()
        cli = _torchrun_cli(tmp)
        t_d = time.perf_counter()
        res = {}
        for f in os.listdir(tmp):
            if f.endswith(".json"):
                with open(os.path.join(tmp, f)) as fh:
                    res[f[:-5]] = json.load(fh)
        out = cards_report(res, tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["torchrun"] = cli
    out["stage_s"] = dict(B=t_b - t_a, C=t_c - t_b, D=t_d - t_c)
    log(f"[cards] torchrun CLI: exit 0 in {cli['wall_s']:.1f} s, "
        f"checkpoints {cli['checkpoints']}, {cli['train_records']} train "
        f"records, {cli['eval_records']} evaluations, videos "
        f"{cli['videos']} [{card}]")
    check(cli["checkpoints"] == ["full_latest", f"model_{cli['total']}"],
          f"torchrun: checkpoints {cli['checkpoints']}")
    check(cli["train_records"] == cli["expected_train_records"]
          and cli["eval_records"]
          and cli["videos"], "torchrun: records or video missing")
    log(f"[cards] stages (s): {out['stage_s']}")
    return out


def _metrics_close(got: dict, want: dict) -> bool:
    return sorted(got) == sorted(want) and all(
        abs(got[k] - want[k]) <= METRIC_TOL["atol"]
        + METRIC_TOL["rtol"] * abs(want[k]) for k in want)


def _first_updating_step(d: str) -> int:
    """The first train step of a run with gradient updates (SAC's first
    warms up)."""
    return min(int(f.split("_")[1]) for f in os.listdir(d)
               if f.startswith("update_"))


def _updates_close(got_dir: str, got_step: int, want_dir: str,
                   want_step: int) -> list:
    """adam_close of the agents after each of the first CARD_PARITY_UPDATES
    gradient updates of two train steps (``_snapshot_updates``' files)."""
    def load(d, step, k):
        return torch.load(os.path.join(d, f"update_{step}_{k}.pt"),
                          weights_only=True)
    return [adam_close(load(got_dir, got_step, k), load(want_dir, want_step, k))
            for k in range(1, CARD_PARITY_UPDATES + 1)]


def _close_text(c: dict) -> str:
    return (f"{'ok' if c['ok'] else 'OVER'} ({c['elements_over_tol']} over, "
            f"worst {c['worst'] or '-'} {c['worst_over_tol']:.3g})")


def cards_report(res: dict, tmp: str, card: str) -> dict:
    """Hold the world-CARDS runs to one process and to themselves: every
    comparison is made and logged first, then checked."""
    import torch.distributed.constants as dc
    from torchdriveenv_tpu_torch.config import EnvConfig
    pool = EnvConfig().reset_pool     # the recipes' pooled reset renders it
    ranks = [res[f"w{CARDS}_rank{r}"] for r in range(CARDS)]
    one = {}
    for k, v in res.items():
        if k.startswith("w1_card"):
            one.update(v)
    w4, w1 = os.path.join(tmp, f"w{CARDS}"), os.path.join(tmp, "w1")
    out = dict(backend=CARDS_BACKEND, world=CARDS, runs={}, resume={})
    checks = []
    for run in ("ppo_wide", "ppo", "sac"):
        recipe, envs, _ = CARD_RUNS[run]
        spi = _card_steps_per_iter(recipe, envs)
        env_steps = spi // envs
        r0, ref = ranks[0][run], one[run]
        # held: the first gradient updates from one state; reported: the
        # runs after each whole train step, and their metrics
        start = _first_updating_step(os.path.join(w4, run))
        first = _updates_close(os.path.join(w4, run), start,
                               os.path.join(w1, run), start)
        steps = [adam_close(*(torch.load(os.path.join(
            d, run, "ckpt", f"model_{k * spi}"), weights_only=True,
            map_location="cpu") for d in (w4, w1)))
            for k in range(1, CARD_TRAIN_STEPS + 1)]
        metrics_ok = [_metrics_close(g["metrics"], w["metrics"])
                      for g, w in zip(r0["rows"], ref["rows"])]
        launches = [[row["host_launches"] for row in r[run]["rows"]]
                    for r in ranks]
        batches = [sorted({b for row in r[run]["rows"]
                           for b in row["render_batches"]}) for r in ranks]
        local = r0["local_envs"]
        rep = dict(
            envs=envs, local_envs=local, first_updating_step=start,
            first_updates=first, train_steps=steps, metrics_ok=metrics_ok,
            metrics=[[g["metrics"], w["metrics"]]
                     for g, w in zip(r0["rows"], ref["rows"])],
            ranks_equal=[r[run]["ranks_equal"] for r in ranks],
            launches=launches, render_batches=batches,
            saved=[r[run]["saved"] for r in ranks],
            peak_gb=[r[run]["peak_gb"] for r in ranks],
            one_process_peak_gb=ref["peak_gb"])
        if "ring_gb" in r0:
            rep.update(ring_gb_per_rank=r0["ring_gb"],
                       ring_gb_global=r0["ring_gb"] * CARDS,
                       card_gb=r0["card_gb"])
        out["runs"][run] = rep
        log(f"[cards] {run} ({recipe}, {envs} envs, {local} a card, f32, "
            f"cuDNN off), world {CARDS} ({CARDS_BACKEND}) against one "
            f"process: ranks equal {rep['ranks_equal']}; after each of the "
            f"first {CARD_PARITY_UPDATES} gradient updates "
            + ", ".join(_close_text(c) for c in first)
            + f"; after each of {CARD_TRAIN_STEPS} train steps "
            + ", ".join(_close_text(c) for c in steps)
            + f"; metrics within rtol 1e-4 / atol 1e-5 {metrics_ok}; "
            f"rasterizer launches per train step per rank {launches} "
            f"({env_steps} env steps), rendered batches {batches}; saved by "
            f"rank {[len(x) for x in rep['saved']]}; peak GB per rank "
            f"{[round(x, 2) for x in rep['peak_gb']]} (one process "
            f"{ref['peak_gb']:.2f}) [{card}]")
        checks += [
            (all(rep["ranks_equal"]), f"{run}: the ranks' agents differ"),
            (all(c["ok"] for c in first),
             f"{run}: world {CARDS} differs from one process within its first "
             f"{CARD_PARITY_UPDATES} gradient updates: {first}"),
            (all(n == 2 * env_steps for ls in launches for n in ls),
             f"{run}: rasterizer launches {launches}"),
            (all(local in b and max(b) <= max(local, pool) for b in batches),
             f"{run}: rendered batches {batches}"),
            (all(not x for x in rep["saved"][1:])
             and any(n.startswith("model_") for n in rep["saved"][0]),
             f"{run}: saved {rep['saved']}")]
        if run in CARD_SNAPSHOT_RUNS:
            checks.append((rep["saved"][0].count("full_latest") == 2,
                           f"{run}: full_latest written {rep['saved'][0]}"))
    if "ring_gb_per_rank" in out["runs"]["sac"]:
        s = out["runs"]["sac"]
        log(f"[cards] the replay ring: {s['ring_gb_per_rank']:.2f} GB of "
            f"frames a card, {s['ring_gb_global']:.2f} GB gathered on every "
            f"card for full_latest; peak allocated per card "
            f"{[round(x, 2) for x in s['peak_gb']]} GB of {s['card_gb']:.1f}")

    for run in CARD_SNAPSHOT_RUNS:
        want = ranks[0][run]["rows"][-1]["metrics"]
        for label, r, d in ((f"world {CARDS}", ranks[0], w4),
                            ("one process", one, w1)):
            got = r[f"{run}_resumed"]
            c = got["against_unbroken"]
            rep = dict(c, first_updates=_updates_close(
                os.path.join(d, f"{run}_resumed"), 1, os.path.join(w4, run),
                CARD_TRAIN_STEPS),
                metrics_ok=_metrics_close(got["rows"][-1]["metrics"], want),
                train_steps=len(got["rows"]))
            out["resume"][f"{run} {label}"] = rep
            log(f"[cards] {run}: world-{CARDS} full_latest at train step "
                f"{CARD_RESUME_AT} resumed in {label} for one train step, "
                f"against the world-{CARDS} run without a break: after each of "
                f"the first {CARD_PARITY_UPDATES} gradient updates "
                + ", ".join(_close_text(x) for x in rep["first_updates"])
                + f"; after the train step: bit-equal {rep['bit_equal']}, "
                f"agent {_close_text(rep['agent'])}, step count and generator "
                f"equal {rep['same_step_and_generator']}, env rows, frames "
                f"and replay ring ok {rep['envs_ok']} (max error "
                f"{rep['max_state_err']:.2e}, frames apart "
                f"{rep['pixel_share']:.2e}), metrics ok {rep['metrics_ok']}")
            held = (rep["train_steps"] == 1
                    and all(x["ok"] for x in rep["first_updates"])
                    and rep["same_step_and_generator"] and rep["envs_ok"])
            if r is not one:    # the same ranks and order: the same run
                held = held and rep["bit_equal"]
            checks.append((held, f"{run} resumed in {label}: {rep}"))

    # the evaluation after the first train step: rank 0 evaluates and
    # records video while the others wait in their next collective
    wide = [r["ppo_wide"]["rows"] for r in ranks]
    gap = wide[0][1]["host_start"] - wide[0][0]["host_end"]
    timeout = getattr(dc, "default_pg_nccl_timeout", None)
    out["evaluation"] = dict(
        rank0_gap_s=gap,
        nccl_default_timeout_s=timeout.total_seconds() if timeout else None)
    episodes = [RECIPES[PPO_YML][k]["eval_n_episodes"]
                for k in ("eval_val_callback", "eval_train_callback")]
    log(f"[cards] ppo_wide's evaluation ({episodes[0]} + {episodes[1]} "
        f"episodes, one video) on rank 0 between train steps 1 and 2: "
        f"{gap:.1f} s; nccl's default timeout "
        f"{out['evaluation']['nccl_default_timeout_s']} s [{card}]")

    # the witnesses of summation order: one process, a first updating
    # train step's updates twice from one state, the second time with the
    # rows of each batch in another order. World CARDS's departure from
    # one process after that train step is held to the same order as the
    # witness's
    out["order_witness"] = {}
    for run, job in (("ppo_wide", "ppo_order"), ("sac", "sac_order")):
        w, r = one[job], out["runs"][run]
        sharded = r["train_steps"][r["first_updating_step"] - 1]
        ratio = sharded["worst_over_tol"] / max(w["whole"]["worst_over_tol"],
                                                1e-30)
        out["order_witness"][run] = dict(w, world_against_one=sharded,
                                         ratio=ratio)
        log(f"[cards] one process, {run}'s first updating train step "
            f"twice from one state with each batch's rows in another order "
            f"(the same sums): after each of the first "
            f"{CARD_PARITY_UPDATES} gradient updates "
            + ", ".join(_close_text(c) for c in w["updates"])
            + f"; after all {w['gradient_steps']}: {_close_text(w['whole'])}"
            f"; world {CARDS} against one process after that train step: "
            f"{_close_text(sharded)}, {ratio:.3g} times the witness's worst "
            f"(held to at most {CARD_WITNESS_ORDER})")
        checks += [
            (all(c["ok"] for c in w["updates"]),
             f"{run}: reordered rows left the tolerance within "
             f"{CARD_PARITY_UPDATES} updates: {w['updates']}"),
            (ratio <= CARD_WITNESS_ORDER,
             f"{run}: world {CARDS} departs {ratio:.3g} times as far as "
             f"reordered rows in one process, over {CARD_WITNESS_ORDER}")]

    out["recipe_runs"] = {}
    for run in ("ppo_wide_recipe", "ppo_per_card_recipe", "sac_recipe"):
        recipe, envs, _ = CARD_RUNS[run]
        spi = _card_steps_per_iter(recipe, envs)
        launches = [[row["host_launches"] for row in r[run]["rows"]]
                    for r in ranks]
        out["recipe_runs"][run] = dict(envs=envs, launches=launches)
        log(f"[cards] {run} ({envs} envs, the recipe's precision), world "
            f"{CARDS}: rasterizer launches per train step per rank "
            f"{launches} [{card}]")
        checks.append((all(n == 2 * spi // envs for ls in launches
                           for n in ls),
                       f"{run}: rasterizer launches {launches}"))
    for ok, msg in checks:
        check(ok, msg)
    return out


def all_cards() -> list:
    """`nvidia-smi --query-gpu=name,power.limit` of every card."""
    import subprocess
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()


def cards_main() -> int:
    """``python3 chip_smoke.py --cards 4``: build the kernels, then
    cards_phase; the same last line as the default run."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < CARDS:
        print(f"chip_smoke --cards {CARDS}: {torch.cuda.device_count()} "
              "card(s) visible", file=sys.stderr)
        return 2
    from torchdriveenv_tpu_torch.ops import _build
    cards = all_cards()
    card = cards[0]
    log(f"cards: {cards}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build()
    log(f"[build] {time.perf_counter() - t0:.1f} s")
    out = cards_phase(card)
    print(json.dumps({"cards_path": dict(out, cards=cards)}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# ---- the [parity] phase: the port held to the JAX reference on the card,
# and the card to the CPU at the main path's width ---------------------------
PARITY_STEPS = 10
# envs whose frames the CPU renders at each step (the twin takes about a
# minute for all 4096 envs on the machine's CPU); evenly spaced
PARITY_FRAME_ENVS = 64
# flipped envs allowed, as a share of the batch (stated before the first run)
PARITY_FLIP_SHARE = {"route": 1e-3, "policy": 2e-3, "pooled": 1e-3}
PARITY_PIXEL_SHARE = 1e-3
PARITY_SEED = 5
# the learners' sizes: SAC at the stage-1 recipe's batch, the others cut so
# that the CPU's side stays well under 30 s
PARITY_SAC_BATCH = RECIPE_BATCH
PARITY_TD3_BATCH = 512
PARITY_PPO = dict(n_steps=16, envs=128, batch_size=1024, n_epochs=1)
PARITY_A2C = dict(n_steps=16, envs=64)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
# CPU updates before the compared one: a fresh Adam's first step is +-lr on
# every element, so a gradient within an ulp of zero flips by 2 lr
PARITY_WARM_UPDATES = 2


@contextlib.contextmanager
def shared_draws(cpu_assets, seed):
    """While active, every reset draws its randomness with
    ``core.sample_reset_draws`` on the CPU, from one generator per device
    seeded alike, and moves the draws to the envs' device: the card and the
    CPU then start episodes from the same draws, and ``reset_from_draws``
    runs on both (the generators are kept by assets object, so a CPU
    rehearsal's two sides draw alike too)."""
    from torchdriveenv_tpu_torch.env import core
    plain = core.sample_reset_draws
    gens = {}

    def drawn(n, generator, assets, cfg, case=None):
        g = gens.setdefault(id(assets), torch.Generator().manual_seed(seed))
        d = plain(n, g, cpu_assets, cfg, None if case is None else case.cpu())
        return core.ResetDraws(**{f.name: getattr(d, f.name).to(assets.device)
                                  for f in dataclasses.fields(d)})

    core.sample_reset_draws = drawn
    try:
        yield
    finally:
        core.sample_reset_draws = plain


def _pooled_mask(n):
    """The [multi] phase's uneven done mask: every second env of the first
    half, every eighth of the second (1280 of 4096)."""
    i = torch.arange(n)
    return torch.where(i < n // 2, i % 2 == 0, i % 8 == 0)


def env_parity(card_assets, cpu_assets, dev, n, card) -> dict:
    """The card's env path against the CPU's at width ``n``: a reset and
    PARITY_STEPS steps in each NPC mode, then one pooled step with the
    [multi] mask's envs at their last step, through make_env_fns with the
    same draws and actions. The card renders every env through the kernel;
    the CPU renders PARITY_FRAME_ENVS of them through the twin. Flips are
    counted by env (utils/reference.py) and bounded by PARITY_FLIP_SHARE."""
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env.batched import _obs_batched, make_env_fns
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    from torchdriveenv_tpu_torch.utils import reference as ref
    import numpy as np

    rows = torch.arange(0, n, max(n // PARITY_FRAME_ENVS, 1))
    rng = np.random.default_rng(PARITY_SEED)
    acts = torch.from_numpy(rng.uniform(
        (-1.0, -0.3), (1.0, 0.3), (PARITY_STEPS, n, 2)).astype(np.float32))
    out, cpu_s = {}, 0.0
    for mode in ("route", "policy", "pooled"):
        cfg = EnvConfig(npc_mode="policy" if mode == "policy" else "route")
        steps = 1 if mode == "pooled" else PARITY_STEPS
        tr = ref.FlipTracker(envs=n, bound=int(PARITY_FLIP_SHARE[mode] * n))
        pixels = []

        def frames(obs_card, state_cpu):
            """Pixels apart in the sampled envs that have not flipped."""
            nonlocal cpu_s
            keep = rows[~tr.flipped[rows]]
            t0 = time.perf_counter()
            twin = _obs_batched(cfg, cpu_assets, state_cpu.take(keep))
            cpu_s += time.perf_counter() - t0
            apart = int((obs_card[keep.to(obs_card.device)].cpu() != twin).sum())
            pixels.append(apart / max(twin.numel(), 1))

        with shared_draws(cpu_assets, PARITY_SEED + len(out)):
            reset_d, step_d = make_env_fns(cfg, card_assets, render=True)
            reset_c, step_c = make_env_fns(cfg, cpu_assets, render=False)
            g_d = torch.Generator(device=dev)
            g_c = torch.Generator()
            _sync(dev)
            rc.render_obs_cuda.launches = 0
            st_d, obs_d = reset_d(g_d, n)
            t0 = time.perf_counter()
            st_c, _ = reset_c(g_c, n)
            cpu_s += time.perf_counter() - t0
            if mode == "pooled":
                last = torch.where(_pooled_mask(n),
                                   cfg.max_environment_steps - 1,
                                   0).to(torch.int32)
                st_d = st_d.replace(step_idx=last.to(dev))
                st_c = st_c.replace(step_idx=last)
            tr.update({f"state/{k}": getattr(st_d, k) for k in st_c._fields()},
                      {f"state/{k}": getattr(st_c, k) for k in st_c._fields()})
            frames(obs_d, st_c)
            done = 0
            for t in range(steps):
                dec_d = ref.npc_decisions(cfg, card_assets.maps, st_d)
                dec_c = ref.npc_decisions(cfg, cpu_assets.maps, st_c)
                a = acts[t]
                o_d = step_d(st_d, a.to(dev), g_d)
                t0 = time.perf_counter()
                o_c = step_c(st_c, a, g_c)
                cpu_s += time.perf_counter() - t0
                tr.update(dict(ref.step_outputs(
                    o_d.state, o_d.reward, o_d.terminated, o_d.truncated,
                    o_d.info), **dec_d),
                    dict(ref.step_outputs(
                        o_c.state, o_c.reward, o_c.terminated, o_c.truncated,
                        o_c.info), **dec_c))
                frames(o_d.obs, o_c.state)
                done += int((o_c.terminated | o_c.truncated).sum())
                st_d, st_c = o_d.state, o_c.state
            _sync(dev)
            launches = rc.render_obs_cuda.launches
        res = dict(tr.result(), mode=mode, pixel_share_max=max(pixels),
                   launches=launches, done=done, frame_envs=int(rows.numel()))
        res["ok"] = (res["ok"] and res["pixel_share_max"] <= PARITY_PIXEL_SHARE
                     and bool(torch.isfinite(st_d.agent_states).all()))
        log(f"[parity] env {mode}: {n} envs x {steps} steps, card against "
            f"the CPU: largest error {res['max_err']:.3g} "
            f"({res['max_err_name']}), flipped envs {res['flipped_envs']} "
            f"(bound {res['flip_bound']}; first flipped by "
            f"{res['flips_by'] or '-'}), done {done}, frames of "
            f"{res['frame_envs']} envs a step: largest share of pixels apart "
            f"{res['pixel_share_max']:.3g}, rasterizer host launches "
            f"{launches}"
            + (f"; first float fault: {res['float_fail']}"
               if res["float_fail"] else "") + f" [{card}]")
        check(res["ok"], f"[parity] env {mode} out of bounds: {res}")
        if torch.device(dev).type == "cuda":
            # the reset, then the step's eager call and its capture: the
            # later steps replay the launch that the capture recorded
            want = 1 + host_launches(0, steps, renders=1)
            check(launches == want,
                  f"[parity] env {mode}: {launches} rasterizer host launches, "
                  f"not {want}")
        out[mode] = res
    out["cpu_s"] = cpu_s
    return out


def _update_args(kind, rng, cpu_agent):
    """The CPU tensors of one update from seeded numpy inputs: a replay
    batch and its noise (SAC, TD3), or a time-major rollout on random
    frames whose actions, log-probs and values are ``cpu_agent``'s own, as
    the train step stores them, its last values and, for PPO, the
    permutations. -> (args, kwargs) of ``update``."""
    import numpy as np

    def t(x):
        return torch.from_numpy(x)

    if kind in ("sac", "td3"):
        b = PARITY_SAC_BATCH if kind == "sac" else PARITY_TD3_BATCH
        batch = dict(
            obs=rng.integers(0, 256, (b, 9, 64, 64), dtype=np.uint8),
            next_obs=rng.integers(0, 256, (b, 9, 64, 64), dtype=np.uint8),
            action=np.clip(rng.uniform(-1.3, 1.3, (b, 2)), -1, 1
                           ).astype(np.float32),
            reward=rng.normal(size=b).astype(np.float32),
            discount_mask=(rng.random(b) > 0.25).astype(np.float32),
            done=rng.random(b) < 0.25, is_demo=np.arange(b) % 2 == 0,
            pos=np.arange(b))
        noise = [t(rng.normal(size=(b, 2)).astype(np.float32))
                 for _ in range(2 if kind == "sac" else 1)]
        return ({k: t(v) for k, v in batch.items()},), dict(
            noise=noise if kind == "sac" else noise[0])
    size = PARITY_PPO if kind == "ppo" else PARITY_A2C
    n_t, e = size["n_steps"], size["envs"]
    obs = t(rng.integers(0, 256, (n_t, e, 9, 64, 64), dtype=np.uint8))
    act, logp, value = cpu_agent.select_action(
        obs.reshape((n_t * e,) + obs.shape[2:]),
        noise=t(rng.normal(size=(n_t * e, 2)).astype(np.float32)))
    rollout = dict(obs=obs, action=act.reshape(n_t, e, 2),
                   log_prob=logp.reshape(n_t, e), value=value.reshape(n_t, e),
                   reward=t(rng.normal(size=(n_t, e)).astype(np.float32)),
                   done=t(rng.random((n_t, e)) < 0.2))
    last_value = cpu_agent.value(t(rng.integers(0, 256, (e, 9, 64, 64),
                                                dtype=np.uint8)))
    kw = {}
    if kind == "ppo":
        kw["perms"] = t(np.stack([rng.permutation(n_t * e)
                                  for _ in range(size["n_epochs"])]))
    return (rollout, last_value), kw


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on(v, dev) for v in tree)
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _learner_pair(kind, dev, rng):
    """(CPU agent, card agent) in f32 in one state: a seeded init on the CPU
    (SAC's actor: the shipped deliverable's, converted from the JAX tree),
    warmed by PARITY_WARM_UPDATES updates on the CPU so that Adam's moments
    are not zero, then copied to the card."""
    from torchdriveenv_tpu_torch.models import load_actor
    from torchdriveenv_tpu_torch.rl.a2c import A2C, A2CConfig
    from torchdriveenv_tpu_torch.rl.ppo import PPO, PPOConfig
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    from torchdriveenv_tpu_torch.rl.td3 import TD3, TD3Config

    def make():
        if kind == "sac":
            return SAC(SACConfig(**_SAC["algo_kwargs"]),
                       compute_dtype=torch.float32)
        if kind == "td3":
            return TD3(TD3Config(batch_size=PARITY_TD3_BATCH),
                       compute_dtype=torch.float32)
        if kind == "ppo":
            return PPO(PPOConfig(**{k: PARITY_PPO[k] for k in (
                "n_steps", "batch_size", "n_epochs")}),
                compute_dtype=torch.float32)
        return A2C(A2CConfig(n_steps=PARITY_A2C["n_steps"]),
                   compute_dtype=torch.float32)

    cpu, card = make(), make()
    cpu.init(seed=PARITY_SEED, device="cpu")
    if kind == "sac":
        cpu.state.actor.load_state_dict(load_actor(device="cpu").state_dict())
    for _ in range(PARITY_WARM_UPDATES):
        args, kw = _update_args(kind, rng, cpu)
        cpu.update(*args, **kw)
    card.init(seed=PARITY_SEED, device=dev)
    card.load_state(cpu.export_state())
    return cpu, card


def learner_parity(dev, card) -> dict:
    """One update of SAC, PPO, A2C and TD3 on the card against the CPU, in
    f32 with cuDNN off (TF32 is off everywhere), from one state with the
    same inputs: parameters, targets and Adam moments within the CPU tests'
    Adam tolerance, metrics at rtol 1e-4 / atol 1e-5."""
    import numpy as np
    out, cpu_s = {}, 0.0
    torch.backends.cudnn.enabled = False
    try:
        for i, kind in enumerate(("sac", "ppo", "a2c", "td3")):
            rng = np.random.default_rng(PARITY_SEED + i)
            cpu, card_agent = _learner_pair(kind, dev, rng)
            args, kw = _update_args(kind, rng, cpu)
            t0 = time.perf_counter()
            m_cpu = cpu.update(*args, **kw)
            cpu_s += time.perf_counter() - t0
            m_card = card_agent.update(*_on(args, dev), **_on(kw, dev))
            metrics = {side: {k: float(v) for k, v in m.items()}
                       for side, m in (("cpu", m_cpu), ("card", m_card))}
            cmp = adam_close(_on(card_agent.export_state(), "cpu"),
                             cpu.export_state())
            m_err = max(abs(metrics["card"][k] - metrics["cpu"][k])
                        for k in metrics["cpu"])
            m_ok = all(abs(metrics["card"][k] - v)
                       <= METRIC_TOL["atol"] + METRIC_TOL["rtol"] * abs(v)
                       for k, v in metrics["cpu"].items())
            rows = "rows" if kind in ("sac", "td3") else "transitions"
            size = (args[0]["obs"].shape[0] if kind in ("sac", "td3")
                    else args[0]["reward"].numel())
            res = dict(cmp, metrics_ok=m_ok, metrics_max_err=m_err,
                       size=int(size), metrics=metrics)
            res["ok"] = cmp["ok"] and m_ok
            log(f"[parity] {kind.upper()} update, card against the CPU (f32, "
                f"cuDNN off) on {size} {rows} after "
                f"{PARITY_WARM_UPDATES} warm-up updates: bit-equal "
                f"{cmp['bit_equal']}, worst {cmp['worst']} at "
                f"{cmp['worst_over_tol']:.3g} of its tolerance, elements "
                f"over {cmp['elements_over_tol']}; metrics largest error "
                f"{m_err:.3g} [{card}]")
            check(res["ok"], f"[parity] {kind} update out of bounds: {res}")
            out[kind] = res
    finally:
        torch.backends.cudnn.enabled = True
    out["cpu_s"] = cpu_s
    return out


def exact_div_parity(dev) -> dict:
    """``maps.arrays.exact_div`` on ``dev`` against the CPU, bit for bit, for
    every divisor of the port's env step, NPC features, scripted drivers
    and CNN input; beside it, how many quotients ``x / divisor`` (torch's
    own kernel) puts an ulp away."""
    from torchdriveenv_tpu_torch.maps.arrays import exact_div
    from torchdriveenv_tpu_torch.npc.route_follow import _IDM_DENOM
    g = torch.Generator().manual_seed(PARITY_SEED)
    x = torch.cat([torch.arange(256, dtype=torch.float32),
                   (torch.rand(1 << 20, generator=g) - 0.5) * 160.0])
    out = {}
    for d in (0.1, 10.0, 22.0, 30.0, 40.0, 60.0, 255.0, _IDM_DENOM):
        want = exact_div(x, d)
        out[str(d)] = dict(
            apart=int((exact_div(x.to(dev), d).cpu() != want).sum()),
            plain_apart=int(((x.to(dev) / d).cpu() != want).sum()))
    log(f"[parity] exact_div on {dev} against the CPU on {x.numel()} values "
        f"a divisor: quotients apart {sum(v['apart'] for v in out.values())}"
        f"; torch's x / d apart: " + ", ".join(
            f"/{d} {v['plain_apart']}" for d, v in out.items()))
    check(all(v["apart"] == 0 for v in out.values()),
          f"[parity] exact_div on {dev} differs from the CPU: {out}")
    return out


def parity_phase(card, dev="cuda", n=N_ENVS) -> dict:
    """Phase [parity]: (A/B) the JAX reference file replayed on ``dev``
    (utils/reference.py); (C) the env at width ``n`` and the four learners'
    updates on ``dev`` against the CPU."""
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.utils import reference as ref
    t0 = time.perf_counter()
    checks = ref.run_reference_checks(load_assets("val", device=dev), dev)
    for name, c in checks.items():
        log(f"[parity] JAX reference {name} on {dev}: largest error "
            f"{c['max_err']:.3g} ({c['max_err_name'] or '-'}), flipped envs "
            f"{c['flipped_envs']} of {c['envs']} (bound {c['flip_bound']}; "
            f"first flipped by {c['flips_by'] or '-'}), agents within "
            f"{ref.FOLD_EPS} of the fold {c['fold_agents']}, steps {c['steps']}"
            + (f"; first float fault: {c['float_fail']}"
               if c["float_fail"] else ""))
        check(c["ok"], f"[parity] JAX reference {name}: {c}")
    ref_s = time.perf_counter() - t0
    divisions = exact_div_parity(dev)
    env = env_parity(load_assets("train", device=dev),
                     load_assets("train", device="cpu"), dev, n, card)
    learners = learner_parity(dev, card)
    total = time.perf_counter() - t0
    log(f"[parity] done in {total:.1f} s (the reference file {ref_s:.1f} s; "
        f"the CPU's side: env {env['cpu_s']:.1f} s, updates "
        f"{learners['cpu_s']:.1f} s)")
    return dict(reference=checks, divisions=divisions, env=env,
                learners=learners, seconds=total, reference_s=ref_s)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this test runs only on a GPU",
              file=sys.stderr)
        return 2
    from torchdriveenv_tpu_torch.config import EnvConfig
    from torchdriveenv_tpu_torch.env.batched import BatchedEnv
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.ops import _build
    from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc
    from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

    set_f32_precision()
    card = all_cards()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    have = optional_packages()
    log("optional packages that import here: "
        + ", ".join(f"{k} {'yes' if v else 'no'}" for k, v in have.items()))

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

    k_ms = cuda_ms(lambda: rc.render_obs_cuda(maps, state.town, *main_prep),
                   100)
    p_ms = cuda_ms(lambda: rc.render_obs_torch(maps, state.town, *main_prep), 3)
    cost = rc.render_cost(maps, state.town, *main_prep)
    b_ms = cost["bytes"] / PEAK_HBM_BYTES * 1e3
    o_ms = cost["flops_scan_all"] / PEAK_F32_OPS * 1e3
    culled_ms = cost["flops"] / PEAK_F32_OPS * 1e3
    # The operation count is that of scanning every listed segment on every
    # pixel. A kernel that beats it does fewer operations than it counts, so
    # only the bytes still bound it.
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
    log(f"[kernels] rasterizer main batch: kernel {k_ms:.4f} ms, twin "
        f"{p_ms:.4f} ms, bounds: bytes {b_ms:.4f} ms, operations of a scan of "
        f"every listed segment {o_ms:.4f} ms, operations of what survives "
        f"the culls {culled_ms:.4f} ms; segments "
        f"per env: listed {surv['nseg_mean']:.1f}, after the frame cull "
        f"{surv['frame_segments_mean']:.1f}, per tile "
        f"{surv['tile_segments_mean']:.2f} (max {surv['tile_segments_max']}); "
        f"per tile: agents {surv['tile_agents_mean']:.2f}, waypoints "
        f"{surv['tile_waypoints_mean']:.2f}, stoplines "
        f"{surv['tile_stoplines_mean']:.3f}, ego {surv['tile_ego_share']:.3f} "
        f"[{card}]")
    main_cmp = dict(max_abs_err=float((kern.int() - twin.int()).abs().max()),
                    ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                    bound_by=bound_by, bytes_bound_ms=b_ms,
                    scan_all_operations_bound_ms=o_ms,
                    culled_operations_bound_ms=culled_ms, **surv)
    del kern, twin

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
    npc_cmp = npc_gaps_check(assets, state, act, card)
    torso = torso_input_check(card)

    parity = parity_phase(card)
    maps_path = maps_phase(assets, state, card)

    # ---- 3. the main path ----------------------------------------------
    cfg = EnvConfig()
    env = BatchedEnv(cfg, assets, N_ENVS, seed=3)
    state, obs = env.reset()
    for _ in range(4):
        state = env.step(state, act).state
    # the path traced: what the kernel ran

    def traced():
        nonlocal state
        for _ in range(TRACED_STEPS):
            o = env.step(state, act)
            state = o.state
        return o

    out, counts, host = trace_runs(traced, TRACED_STEPS)
    launches = max(counts)
    checksum = int(out.obs.sum())
    log(f"[main] {N_ENVS} envs, in traces of {TRACED_STEPS} steps: "
        f"rasterizer kernel runs {counts}, host launches {host}; obs "
        f"checksum {checksum} [{card}]")
    if launches != TRACED_STEPS:
        raise AssertionError(f"rasterizer kernel ran {counts} times in "
                             f"{TRACED_STEPS} renders")
    if host != 0:
        raise AssertionError(f"{host} host launches in steps that replay "
                             "their graphs")
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
    _, npc_counts, npc_host = trace_runs(traced, TRACED_STEPS,
                                         runs=npc_gaps_runs)
    log(f"[main] in traces of {TRACED_STEPS} more steps, NPC kernel runs "
        f"{npc_counts}, host launches {npc_host}")
    check(max(npc_counts) == TRACED_STEPS, f"NPC kernel ran {npc_counts} "
          f"times in {TRACED_STEPS} steps")
    check(npc_host == 0, f"{npc_host} NPC kernel host launches in steps that "
          "replay their graphs")

    fenv = BatchedEnv(cfg, assets, N_ENVS, seed=4, with_final_obs=True)
    fstate, _ = fenv.reset()
    torch.cuda.synchronize()
    rc.render_obs_cuda.launches = 0
    for _ in range(2):                  # the eager step and the capture
        fstate = fenv.step(fstate, act).state
    f_host = rc.render_obs_cuda.launches

    def traced_f():
        nonlocal fstate
        for _ in range(2):
            o = fenv.step(fstate, act)
            fstate = o.state
        return o

    fout, f_counts, host = trace_runs(traced_f, 4)
    log(f"[main] with_final_obs: 2 steps, rasterizer host launches {f_host} "
        f"(the eager step's and the capture's); 2 more, traced: kernel runs "
        f"{f_counts} (batch + pool render per step), host launches {host}")
    if max(f_counts) != 4 or fout.final_obs.shape != (N_ENVS, 3, 64, 64):
        raise AssertionError("with_final_obs path did not render as expected")
    if f_host != 4 or host != 0:
        raise AssertionError(f"host launches {f_host}, {host} with "
                             "with_final_obs")
    del fenv, fstate, fout

    npc = npc_phase(assets, act, card, prep_of)
    gym = gym_phase(assets, state, card, have)
    learner = learner_phase(assets, env, state, act, card)
    del env, state, out
    trained = train_phase(card, have)
    tools = tools_phase(card)
    multi = multi_phase(card)

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
        "multi_launches": multi["world2"]["launches"],
        "tools_launches": tools["rasterizer_host_launches"],
        "bytes_bound_ms": main_cmp["bytes_bound_ms"],
        "scan_all_operations_bound_ms": main_cmp["scan_all_operations_bound_ms"],
        "culled_operations_bound_ms": main_cmp["culled_operations_bound_ms"],
        "cull": {k: main_cmp[k] for k in (
            "frame_segments_mean", "tile_segments_mean", "tile_segments_max",
            "tile_agents_mean", "tile_waypoints_mean", "tile_stoplines_mean",
            "tile_ego_share")},
    }, {
        "name": "npc_gaps",
        "route": "cuda",
        "source": "torchdriveenv_tpu_torch/csrc/npc_gaps.cu",
        "replaces": "torchdriveenv_tpu/npc/route_follow.py:47",
        "launches": max(npc_counts),
        "policy_launches": npc["npc_gaps_runs"],
        "max_abs_err": npc_cmp["max_abs_err"],
        "policy_max_abs_err": npc_cmp["policy_max_abs_err"],
        "ms": npc_cmp["ms"],
        "plain_ms": npc_cmp["plain_ms"],
        "bound_ms": npc_cmp["bound_ms"],
        "bound_by": npc_cmp["bound_by"],
        "library_ms": None,
        "bytes_bound_ms": npc_cmp["bytes_bound_ms"],
        "operations_bound_ms": npc_cmp["operations_bound_ms"],
    }, {
        "name": "torso_input",
        "route": "cuda",
        "source": "torchdriveenv_tpu_torch/csrc/torso_input.cu",
        "replaces": "torchdriveenv_tpu/models/cnn.py:30",
        "launches": trained["torso_input_launches"],
        "max_abs_err": max(v["max_abs_err"] for v in torso["shapes"].values()),
        "ms": torso["ms"],
        "plain_ms": torso["plain_ms"],
        "bound_ms": torso["bound_ms"],
        "bound_by": "bytes",
        "library_ms": torso["plain_ms"],
        "shapes": torso["shapes"],
    }] + [map_kernel_line(maps_path, name) for name in ("stamp", "edt")],
        "main_path": {"traced_steps": TRACED_STEPS, "num_envs": N_ENVS,
                      "obs_checksum": checksum,
                      "nseg_mean": main_cmp["nseg_mean"]},
        "parity_path": parity, "maps_path": maps_path,
        "npc_path": npc, "gym_path": gym, "learner_path": learner,
        "train_path": trained, "tools_path": tools,
        "multi_path": multi}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multi-worker"]:
        sys.exit(multi_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--cards"]:
        if sys.argv[2:] != [str(CARDS)]:
            sys.exit(f"chip_smoke: --cards {CARDS} is the one multi-card mode")
        sys.exit(cards_main())
    sys.exit(main())
