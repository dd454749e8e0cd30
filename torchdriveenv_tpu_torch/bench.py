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
        [--npc {route,policy}]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.env.batched import _autoreset, _obs_batched, make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import load_assets, resolve_device
from torchdriveenv_tpu_torch.npc.policy_net import default_params


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
            lambda: _autoreset(cfg, assets, state, done, generator)),
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


def main(argv=None):
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
    args = ap.parse_args(argv)

    device = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = EnvConfig(npc_mode=args.npc)
    assets = load_assets("train", device=device)
    reset_fn, step_fn = make_env_fns(cfg, assets, render=not args.no_render)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state, _ = reset_fn(gen, args.num_envs)
    actions = torch.tensor([[0.3, 0.0]], device=device).repeat(args.num_envs, 1)

    def chunk(state):
        for _ in range(args.chunk):
            out = step_fn(state, actions, gen)
            state = out.state
        # fold the last obs into a checksum, as the JAX bench does
        return state, out.reward.sum(), out.obs.sum()

    t0 = time.perf_counter()
    state, _, _ = chunk(state)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        state, r_sum, o_sum = chunk(state)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    best = min(times)
    mean_t = sum(times) / len(times)
    cov = (sum((t - mean_t) ** 2 for t in times) / len(times)) ** 0.5 / mean_t
    spread = max(times) / best
    contended = spread > 2.0 or cov > 0.25
    if contended:
        print(f"WARNING: chunk-time spread {spread:.1f}x, CoV {cov:.2f}: the "
              "machine was likely contended; treat this record as suspect",
              file=sys.stderr)

    extra = {}
    if args.profile:
        extra["profile"] = profile_steps(step_fn, state, actions, gen, 8,
                                         args.profile)
    print(json.dumps({
        "metric": "env_steps_per_sec",
        "value": args.num_envs * args.chunk / best,
        "median": args.num_envs * args.chunk / sorted(times)[len(times) // 2],
        "unit": f"env-steps/s ({args.num_envs} envs, "
                f"render={not args.no_render}, npc={args.npc})",
        "chunk_steps": args.chunk,
        "first_chunk_s": first_s,
        "chunk_times_s": times,
        "chunk_time_cov": cov,
        **({"contention_warning": True} if contended else {}),
        "obs_checksum": int(o_sum.item()),
        "reward_checksum": float(r_sum.item()),
        "phases_ms_per_step": phase_ms(cfg, assets, state, gen),
        "device": torch.cuda.get_device_name(0),
        "card": card_line(),
        **extra,
    }))


if __name__ == "__main__":
    main()
