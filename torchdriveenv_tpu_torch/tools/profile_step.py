"""Micro-profiler of the batched env step (port of ``tools/profile_step.py``):
the time of each piece, to guide kernel work.

Pieces: the full step with and without render, a reset alone,
``core.step`` alone (no auto-reset), the NPC route follower, the SDF-grid
``render_egocentric`` (the Gym adapter's renderer), the same with the road
layer constant (without the SDF gather), and ``render_observation`` (the
step's own renderer: ``prepare_obs_inputs``, then the rasterizer kernel).
Each is the best of three calls after a warm-up, on the host clock ending
in a synchronize.

    python -m torchdriveenv_tpu_torch.tools.profile_step [--num_envs 4096]
        [--out report.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

from torchdriveenv_tpu_torch.bench import card_line, timed_ms
from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.env.batched import _obs_batched, make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import load_assets, resolve_device
from torchdriveenv_tpu_torch.npc.route_follow import npc_actions
from torchdriveenv_tpu_torch.ops import rasterizer
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision


def profile(num_envs: int, device=None, iters: int = 3) -> Dict[str, float]:
    """{piece: best ms} for ``num_envs`` train envs on ``device``."""
    dev = resolve_device(device)
    cfg = EnvConfig()
    assets = load_assets("train", device=dev)
    reset_fn, step_fn = make_env_fns(cfg, assets, render=True)
    _, step_nr = make_env_fns(cfg, assets, render=False)
    g = torch.Generator(device=dev).manual_seed(0)
    state, _ = reset_fn(g, num_envs)
    actions = torch.tensor([[0.3, 0.0]], device=dev).repeat(num_envs, 1)
    t = state.time0 + state.step_idx.to(torch.float32) * cfg.simulator.dt
    case = state.case.long()

    def render_ego():
        return rasterizer.render_egocentric(
            assets.maps, state.town, t, state.agent_states, state.agent_attrs,
            state.present, assets.suite.waypoints[case], state.target_idx,
            assets.suite.n_waypoints[case])

    def timed(fn):
        return timed_ms(fn, iters, dev)

    out = {
        "full step (render)": timed(lambda: step_fn(state, actions, g)),
        "full step (no render)": timed(lambda: step_nr(state, actions, g)),
        "reset only": timed(lambda: core.reset(cfg, assets, num_envs, g)),
        "core.step only (no autoreset)": timed(
            lambda: core.step(cfg, assets, state, actions)),
        "npc_actions": timed(lambda: npc_actions(
            assets.maps, state.town, t, state.agent_states,
            state.agent_attrs, state.present, state.npc_target_speed)),
        "render_egocentric": timed(render_ego),
    }
    plain = rasterizer.sample_sdf_nearest
    try:
        rasterizer.sample_sdf_nearest = (
            lambda maps, town, xy: torch.ones(xy.shape[:-1], device=xy.device))
        out["render (road=const, no SDF gather)"] = timed(render_ego)
    finally:
        rasterizer.sample_sdf_nearest = plain
    out["render_observation (kernel path)"] = timed(
        lambda: _obs_batched(cfg, assets, state))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--out", default=None,
                    help="also write the report as JSON there")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)
    set_f32_precision()

    dev = resolve_device(args.device)
    card = card_line() if dev.type == "cuda" else "cpu"
    print(f"batch={args.num_envs} device={dev} card={card}")
    ms = profile(args.num_envs, dev)
    for name, v in ms.items():
        print(f"{name:40s} {v:10.3f} ms")
    report = {"num_envs": args.num_envs, "device": str(dev), "card": card,
              "clock": "host, ending in a synchronize", "ms": ms}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    main()
