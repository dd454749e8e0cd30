"""Learner-side breakdown of the off-policy SAC path (port of
``tools/profile_learner.py``).

The gradient side's counterpart of ``bench.py``: it times
  1. the SAC update alone on a synthetic device-resident batch, over a
     sweep of batch sizes: updates/s, FLOPs per update
     (``torch.utils.flop_counter.FlopCounterMode``), the least bytes an
     update must move, and their shares of the H100's peaks;
  2. the replay-buffer sample alone (the frame-stack gather) over the sweep;
  3. sample + update chained ``--updates_per_iter`` times (the learn phase
     of a train step);
  4. the env rollout segment of the off-policy train step (rendered env
     steps with the pre-reset observation, plus the buffer insertion);
  5. the fused train step (``parallel/train_step.py``) past its warm-up.
On a GPU every section is timed with CUDA events (the least of a few calls
after a warm-up) and its kernel launches are counted in a torch.profiler
trace. On the CPU (``--device cpu``) the times are the host's clock and
launches and shares are not measured (null).

    python -m torchdriveenv_tpu_torch.tools.profile_learner
        [--batches 256 512 1024 2048 4096] [--num_envs 128]
        [--out report.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Callable, Dict, Optional

import torch

from torchdriveenv_tpu_torch.bench import card_line, timed_ms, traced_kernels
from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import load_assets, resolve_device
from torchdriveenv_tpu_torch.models.policies import scale_action
from torchdriveenv_tpu_torch.parallel.train_step import make_offpolicy_train_fns
from torchdriveenv_tpu_torch.rl import buffer as replay
from torchdriveenv_tpu_torch.rl.rollout import RolloutState, init_stack, make_offpolicy_step
from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, HBM3 bandwidth
H100_PEAK_BF16_FLOPS = 989e12
H100_PEAK_HBM_BYTES = 3.35e12
FRAME_STACK, RES = 3, 64


def launches(fn: Callable, device: torch.device) -> Optional[int]:
    """Kernels launched by one call of fn(), from a torch.profiler trace;
    None on the CPU."""
    if device.type != "cuda":
        return None
    with tempfile.TemporaryDirectory() as tmp:
        _, kernels = traced_kernels(fn, os.path.join(tmp, "trace.json"))
    return len(kernels)


def update_flops(agent: SAC, batch, generator) -> int:
    """FLOPs of one update (forward and backward, as FlopCounterMode counts
    the matrix products and convolutions)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        agent.update(batch, generator=generator)
    return int(counter.get_total_flops())


def update_min_bytes(agent: SAC, batch) -> int:
    """The least bytes one update moves: the batch read once; the trained
    parameters and both Adam moments read once and written once; the
    target critic read once and written once (f32)."""
    st = agent.state
    trained = (sum(p.numel() for p in st.actor.parameters())
               + sum(p.numel() for p in st.critic.parameters()) + 1)
    target = sum(p.numel() for p in st.target_critic.parameters())
    batch_bytes = sum(v.numel() * v.element_size() for v in batch.values())
    return batch_bytes + 4 * (2 * 3 * trained + 2 * target)


def synthetic_batch(b: int, generator: torch.Generator, device) -> dict:
    """A replay batch of ``b`` random transitions on ``device``."""
    c = 3 * FRAME_STACK

    def frames():
        return torch.randint(0, 255, (b, c, RES, RES), generator=generator,
                             device=device, dtype=torch.uint8)

    return dict(
        obs=frames(), next_obs=frames(),
        action=torch.rand((b, 2), generator=generator, device=device) * 2 - 1,
        reward=torch.ones(b, device=device),
        discount_mask=torch.ones(b, device=device),
        done=torch.zeros(b, dtype=torch.bool, device=device),
        is_demo=torch.zeros(b, dtype=torch.bool, device=device),
        pos=torch.arange(b, device=device))


def _shares(flops: Optional[float], nbytes: Optional[float], ms: float,
            device: torch.device) -> dict:
    if device.type != "cuda":
        return dict(tensor_share_of_bf16_peak=None, hbm_share_of_peak=None)
    return dict(
        tensor_share_of_bf16_peak=flops / (ms * 1e-3) / H100_PEAK_BF16_FLOPS,
        hbm_share_of_peak=nbytes / (ms * 1e-3) / H100_PEAK_HBM_BYTES)


def profile(batches, num_envs: int, updates_per_iter: int,
            steps_per_iter: int, batch_size: int, buffer_size: int,
            device=None) -> Dict[str, dict]:
    """The five sections' report: the least of 5 calls of an update or a
    sample, of 3 of the longer sections."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(0)
    report = {"device": str(dev), "num_envs": num_envs,
              "clock": "cuda events" if dev.type == "cuda" else "host"}

    # ---- 1. the update alone, batch sweep
    sweep = {}
    for b in batches:
        agent = SAC(SACConfig(batch_size=b), obs_channels=3 * FRAME_STACK)
        agent.init(seed=0, obs_res=RES, device=dev)
        batch = synthetic_batch(b, g, dev)
        flops = update_flops(agent, batch, g)
        nbytes = update_min_bytes(agent, batch)
        ms = timed_ms(lambda: agent.update(batch, generator=g), 5, dev,
                      events=True)
        sweep[b] = dict(ms=ms, updates_per_s=1e3 / ms,
                        samples_per_s=b * 1e3 / ms, flops=flops,
                        min_bytes=nbytes,
                        launches=launches(
                            lambda: agent.update(batch, generator=g), dev),
                        **_shares(flops, nbytes, ms, dev))
        print(f"update b={b}: {ms:.2f} ms ({1e3 / ms:.1f} upd/s), "
              f"{flops / 1e9:.1f} GFLOP, launches {sweep[b]['launches']}",
              file=sys.stderr)
        del agent, batch
    report["update_sweep"] = sweep

    # ---- 2. the replay sample alone, on a full ring of the recipe's shape
    cap = max(buffer_size // num_envs, 256)
    buf = replay.create(num_envs, cap, (3, RES, RES), device=dev)
    buf.pos.fill_(cap)
    buf.filled.fill_(cap)
    samp = {}
    for b in batches:
        def sample(b=b):
            return replay.sample(buf, b, FRAME_STACK, generator=g)
        ms = timed_ms(sample, 5, dev, events=True)
        samp[b] = dict(ms=ms, samples_per_s=b * 1e3 / ms,
                       launches=launches(sample, dev))
        print(f"sample b={b}: {ms:.2f} ms", file=sys.stderr)
    report["sample_sweep"] = samp
    report["buffer"] = {"capacity_per_env": cap, "envs": num_envs,
                        "frames_gb": buf.frames.numel() / 1e9}

    # ---- 3. sample + update chained (the learn phase of a train step)
    agent = SAC(SACConfig(batch_size=batch_size),
                obs_channels=3 * FRAME_STACK)
    agent.init(seed=0, obs_res=RES, device=dev)

    def learn():
        for _ in range(updates_per_iter):
            agent.update(replay.sample(buf, batch_size, FRAME_STACK,
                                       generator=g), generator=g)

    ms = timed_ms(learn, 3, dev, events=True)
    report["learn_phase"] = dict(
        updates_per_iter=updates_per_iter, batch_size=batch_size, ms=ms,
        updates_per_s=updates_per_iter * 1e3 / ms,
        launches=launches(learn, dev))
    print(f"learn phase ({updates_per_iter} x b={batch_size}): {ms:.1f} ms",
          file=sys.stderr)
    del buf

    # ---- 4. the env rollout segment of the off-policy train step
    cfg = EnvConfig()
    assets = load_assets("train", device=dev)
    reset_fn, step_fn = make_env_fns(cfg, assets, render=True,
                                     with_final_obs=True)
    state, obs = reset_fn(g, num_envs)
    rs = RolloutState(state, init_stack(obs, FRAME_STACK))
    rbuf = replay.create(num_envs, cap, (3, RES, RES), device=dev)
    one = make_offpolicy_step(step_fn, None, FRAME_STACK, scale_action,
                              replay.add)

    def roll():
        nonlocal rs
        for _ in range(steps_per_iter):
            rs, _, _ = one(rs, rbuf, g, random_action=True)

    ms = timed_ms(roll, 3, dev, events=True)
    report["rollout_phase"] = dict(
        steps_per_iter=steps_per_iter, ms=ms,
        env_steps_per_s=steps_per_iter * num_envs * 1e3 / ms,
        launches=launches(roll, dev))
    print(f"rollout phase ({steps_per_iter} steps x {num_envs} envs): "
          f"{ms:.1f} ms", file=sys.stderr)
    del rbuf, rs

    # ---- 5. the fused train step, past its warm-up
    init_fn, train_fn = make_offpolicy_train_fns(
        cfg, agent, num_envs, buffer_capacity=cap,
        steps_per_iter=steps_per_iter, updates_per_iter=updates_per_iter,
        device=dev)
    carry = init_fn(assets, 0)
    carry.env_steps = 10_000        # past learning_starts: the updates run

    def train():
        nonlocal carry
        carry, _ = train_fn(assets, carry)

    ms = timed_ms(train, 3, dev, events=True)
    spi = steps_per_iter * num_envs
    report["fused_train_step"] = dict(
        ms=ms, env_steps_per_iter=spi, env_steps_per_s=spi * 1e3 / ms,
        updates_per_s=updates_per_iter * 1e3 / ms,
        launches=launches(train, dev))
    print(f"fused train step: {ms:.1f} ms -> {spi * 1e3 / ms:.0f} "
          f"env-steps/s, {updates_per_iter * 1e3 / ms:.1f} upd/s",
          file=sys.stderr)
    return report


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_envs", type=int, default=128)
    ap.add_argument("--batches", type=int, nargs="+",
                    default=[256, 512, 1024, 2048, 4096])
    ap.add_argument("--updates_per_iter", type=int, default=32)
    ap.add_argument("--steps_per_iter", type=int, default=4)
    ap.add_argument("--batch_size", type=int, default=512,
                    help="the batch of the chained and fused sections")
    ap.add_argument("--out", default=None,
                    help="also write the report as JSON there")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    report = profile(args.batches, args.num_envs, args.updates_per_iter,
                     args.steps_per_iter, args.batch_size,
                     SACConfig().buffer_size, dev)
    report["card"] = card_line() if dev.type == "cuda" else "cpu"
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
        print(f"-> {args.out}", file=sys.stderr)
    return report


if __name__ == "__main__":
    main()
