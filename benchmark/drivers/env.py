"""The env-step driver: ``env/batched.py:make_env_fns``' ``step_fn`` at the
configuration's batch, under the traffic mix's ego actions
(``benchmark/actions/<kind>.py``).

Set-up: the port's assets, the first reset from the seeded generator, the
mix's action source, ``WARMUP_STEPS`` steps. The window: steps until
``seconds`` have passed on the host's clock, a CUDA event recorded after
every step, one ``synchronize`` at the end, the garbage collector off.
``env_steps_per_s`` is envs x steps over the window's time;
``env_step_ms_p95`` the 95th percentile of the gaps between consecutive
events. After the window one more step runs from the state the window
left (the step after its last). With ``trace``, ``TRACE_STEPS`` more steps
run under ``torch.profiler``.

The check: the reference (``benchmark/reference``) resets from the
generator state of the first reset and replays the warm-up on its own,
with the same actions and its own generator, and its state and outputs
after the last warm-up step are compared with the program's. Each compared
step of the window (``SAMPLED_STEPS`` drawn from the seed, and the step
after the window's last) is stepped by the reference from the program's
own state before it, with the same actions and generator state.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List

import torch

from benchmark import compare, gen, manifest
from benchmark import window as win
from benchmark.metrics import _trace

WARMUP_STEPS = 16
TRACE_STEPS = 32
# the compared steps of the window: SAMPLED_STEPS drawn from the seed among
# the first SAMPLE_RATE x seconds (the env steps at least that many a
# second), and the step after the window's last
SAMPLED_STEPS = 2
SAMPLE_RATE = 40


class Saved:
    """What one compared step needs: the program's state and the generator
    state before it, its actions, and its output."""

    def __init__(self, state, gen_state, actions, out):
        self.state, self.gen_state, self.actions, self.out = (
            state, gen_state, actions, out)


class Traced:
    """One traced step: its output and the states its render drew
    (``out.state``: one render a step)."""

    def __init__(self, out):
        self.out = out
        self.rendered = [out.state]


def env_config_raw(config: dict, traffic: dict, sizes: dict) -> dict:
    raw = manifest.merged(config["env"], traffic.get("env", {}))
    return manifest.merged(raw, sizes.get("env", {}))


def run(ctx) -> dict:
    """One run of an env cell -> the readings ``benchmark.run`` turns into
    the result's line."""
    from torchdriveenv_tpu_torch.config import construct_env_config
    from torchdriveenv_tpu_torch.env.batched import make_env_fns
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

    dev = torch.device(ctx.device)
    on_gpu = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    set_f32_precision()
    config, traffic = ctx.config, ctx.traffic
    num_envs = ctx.sizes.get("num_envs", config["num_envs"])
    raw = env_config_raw(config, traffic, ctx.sizes)
    cfg = construct_env_config(raw)
    assets = load_assets(config["suite"], device=dev)
    reset_fn, step_fn = make_env_fns(cfg, assets, render=True)
    if ctx.fault is not None:
        step_fn = ctx.fault(step_fn)

    g = gen.generator(ctx.seed, gen.ENV_STREAM, dev)
    start_gen = g.get_state()
    state0, obs0 = reset_fn(g, num_envs)
    actions_at = gen.action_source(traffic["actions"], num_envs=num_envs,
                                   seed=ctx.seed, device=dev, cfg=cfg,
                                   assets=assets)

    state, k, warm_actions, warm_out = state0, 0, [], None
    for _ in range(WARMUP_STEPS):
        warm_actions.append(actions_at(state, k))
        warm_out = step_fn(state, warm_actions[-1], g)
        state, k = warm_out.state, k + 1
    sync()

    rate = ctx.sizes.get("sample_rate", SAMPLE_RATE)
    sample = set(random.Random(ctx.seed).sample(
        range(max(SAMPLED_STEPS, int(rate * ctx.seconds))), SAMPLED_STEPS))
    saved: List[Saved] = []
    max_events = int(ctx.seconds * 2000) + 2
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(max_events)]
              if on_gpu else [])
    stamps: List[float] = []

    # the window
    setup_s = time.perf_counter() - ctx.t0
    with win.no_gc():
        t_start = time.perf_counter()
        if on_gpu:
            events[0].record()
        else:
            stamps.append(t_start * 1e3)
        n = 0
        deadline = t_start + ctx.seconds
        while True:
            actions = actions_at(state, k)
            if n in sample:
                gs = g.get_state()
            out = step_fn(state, actions, g)
            if on_gpu:
                if n + 1 < max_events:
                    events[n + 1].record()
            else:
                stamps.append(time.perf_counter() * 1e3)
            if n in sample:
                saved.append(Saved(state, gs, actions, out))
            state, k, n = out.state, k + 1, n + 1
            if time.perf_counter() >= deadline:
                break
        sync()
        window_s = time.perf_counter() - t_start

    if on_gpu:
        m = min(n, max_events - 1)
        stamps = [0.0] + [events[0].elapsed_time(e)
                          for e in events[1:m + 1]]
    step_ms = win.intervals_ms(stamps)
    r = {
        "setup_s": setup_s,
        "window_s": window_s,
        "steps": n,
        "attempted": n * num_envs,
        "env_steps_per_s": win.rate(n * num_envs, window_s),
        "env_step_ms_p95": win.percentile(step_ms, 95),
        "per_step_s": window_s / n,
        "step_ms_median": win.percentile(step_ms, 50),
        "step_ms_by_tenth": _tenths(step_ms),
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if on_gpu else 0),
    }
    del events, stamps

    # the step after the window's last, from the state the window left
    actions = actions_at(state, k)
    gs = g.get_state()
    out = step_fn(state, actions, g)
    saved.append(Saved(state, gs, actions, out))
    state, k = out.state, k + 1

    if ctx.trace:
        traced: List = []

        def steps():
            nonlocal state, k
            for _ in range(TRACE_STEPS):
                out = step_fn(state, actions_at(state, k), g)
                traced.append(Traced(out))
                state, k = out.state, k + 1

        r["trace"] = _trace.summarize(*_trace.run_traced(
            steps, ctx.trace_path))
        r["trace_steps"] = TRACE_STEPS
        r["traced"] = traced

    del state, out, assets
    r["ref"] = reference_readings(ctx, raw, num_envs, start_gen, state0,
                                  obs0, warm_actions, warm_out, saved)
    r["compared_steps"] = len(saved)
    r["replayed_steps"] = WARMUP_STEPS
    r["compared_done"] = int(sum(int((s.out.terminated | s.out.truncated)
                                     .sum()) for s in saved))
    return r


def _tenths(values: List[float]) -> List[float]:
    """Mean of each tenth of the window's step times, in order: where in
    the window a run was slow."""
    k = max(len(values) // 10, 1)
    return [sum(values[i:i + k]) / len(values[i:i + k])
            for i in range(0, k * 10, k) if values[i:i + k]]


def reference_readings(ctx, raw: dict, num_envs: int, start_gen, state0,
                       obs0, warm_actions, warm_out,
                       saved: List[Saved]) -> dict:
    """The reference's verdict on the first reset, on the warm-up it
    replays on its own and on every saved step; with ``ctx.control`` the
    control's readings too (the reference in bfloat16 in the program's
    place, judged the same way)."""
    from benchmark.reference import arrays as rarrays
    from benchmark.reference import config as rconfig
    from benchmark.reference import env as renv
    from benchmark.reference import policy_net as rpolicy

    dev = torch.device(ctx.device)
    rcfg = rconfig.env_config(raw)
    rassets = rarrays.load_assets(ctx.config["suite"], device=dev)
    npc = (rpolicy.load_npc_policy(rpolicy.NPC_POLICY, dev)
           if rcfg.npc_mode == "policy" else None)

    def gen_at(state):
        rg = torch.Generator(device=dev)
        rg.set_state(state)
        return rg

    def replay():
        """The first reset, then the warm-up's steps from it."""
        rg = gen_at(start_gen)
        first = renv.reset(rcfg, rassets, num_envs, rg)
        last, st = None, first["state"]
        for a in warm_actions:
            last = renv.step(rcfg, rassets, st, a, rg, npc)
            st = last["state"]
        return first, last

    prog, refs = compare.Tally(), []
    ref0, ref_warm = replay()
    compare.add_reset(prog, state0, obs0, ref0)
    compare.add_step(prog, warm_out, ref_warm)
    for s in saved:
        ref = renv.step(rcfg, rassets, renv.state_from(s.state),
                        s.actions, gen_at(s.gen_state), npc)
        compare.add_step(prog, s.out, ref)
        refs.append(ref)
    out = {"program": prog.readings(), "assets": rassets, "cfg": rcfg,
           "npc": npc}
    if ctx.control:
        out["control"] = control_readings(rcfg, rassets, npc, replay, ref0,
                                          ref_warm, saved, refs, gen_at)
    return out


def control_readings(rcfg, rassets, npc, replay, ref0, ref_warm, saved,
                     refs, gen_at) -> Dict[str, float]:
    from benchmark.reference import arrays as rarrays
    from benchmark.reference import env as renv
    from benchmark.reference.lowp import LowerPrecision

    ctl = compare.Tally()
    rarrays.device_constant.cache_clear()
    try:
        with LowerPrecision(torch.bfloat16):
            low0, low_warm = replay()
            lows = [renv.step(rcfg, rassets, renv.state_from(s.state),
                              s.actions, gen_at(s.gen_state), npc)
                    for s in saved]
    finally:
        rarrays.device_constant.cache_clear()
    compare.add_reset(ctl, low0["state"], low0["obs"], ref0)
    compare.add_step(ctl, _as_output(low_warm), ref_warm)
    for low, ref in zip(lows, refs):
        compare.add_step(ctl, _as_output(low), ref)
    return ctl.readings()


def _as_output(d: dict):
    from types import SimpleNamespace
    return SimpleNamespace(final_obs=d.get("final_obs"), **{
        k: v for k, v in d.items() if k != "final_obs"})
