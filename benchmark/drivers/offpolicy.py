"""The off-policy training driver: ``parallel/train_step.py``'s
``make_offpolicy_train_fns`` with the port's SAC and scripted driver, as
the training CLI builds them for the configuration's recipe.

Set-up: the port's assets and agent; the weights handed to the agent (the
shipped actor read from its file, a fresh critic made on the device from
the seed); the first reset from the seeded generator; ``env_steps`` set to
the configuration's ``start_env_steps`` and the replay ring filled from the
seed with the ``start_env_steps / num_envs`` cells a run holds there
(``benchmark.gen.fill_ring``: the recipe past its demonstration warm-up,
as a resumed run stands); then ``COMPARED_STEPS`` train steps through the
window's own call (they warm every shape up and are what the check
compares). The window: whole train steps until ``seconds`` have passed on
the host's clock, one ``synchronize`` at the end, the garbage collector
off. After it, on the card, ``TRACE_TRAIN_STEPS`` more train steps run
under ``torch.profiler``.
``train_step_device_ms`` is the device's busy time (the union of its
operations' intervals) in those traced train steps, per train step: the
work the card does for a train step, which the host's speed does not move.
``train_env_steps_per_s`` (the per-layer
``train_env_steps_per_s.window``) is the env transitions of the window's
train steps over its time. With ``trace``, the window's updates are timed
with CUDA events.

The check: the reference (``benchmark/reference/sac.py``) resets from the
same generator seed, fills its own ring from the same seed, and follows
the first ``COMPARED_STEPS`` train steps from the same weights. Compared (training's rule): each compared train
step's critic and actor loss (``loss_gap``, relative); the first update's
critic gradient as the program's Adam holds it after one update
(``exp_avg / (1 - beta1)``), by the worst leaf (``grad_gap``); and the
critic's change over the compared steps by the worst leaf (``change_gap``),
each a gap of norms over the larger of the reference's norm of that leaf
and of the median leaf. Leaves whose first reference gradient is under a
thousandth of the median leaf's are left out of the change.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List

import torch

from benchmark import compare, gen, manifest
from benchmark import window as win
from benchmark.drivers.env import _tenths
from benchmark.metrics import _trace

COMPARED_STEPS = 3
TRACE_TRAIN_STEPS = 1
NOUGHT_GRAD = 1e-3          # leaves under this share of the median leaf's
LOSSES = ("critic_loss", "actor_loss")


class Traced:
    """What the traced train step leaves for the per-layer metrics: the
    envs' state after it and the share of envs done per env step in it
    (read from the ring's cells)."""

    def __init__(self, state, done_share: float):
        self.state, self.done_share = state, done_share


def _sizes(config: dict, traffic: dict, sizes: dict):
    raw = manifest.merged(manifest.merged(config["env"],
                                          traffic.get("env", {})),
                          sizes.get("env", {}))
    algo = manifest.merged(config["algo"], sizes.get("algo", {}))
    get = lambda k: sizes.get(k, config[k])  # noqa: E731
    return raw, algo, get


def run(ctx) -> dict:
    from torchdriveenv_tpu_torch.config import construct_env_config
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.parallel.train_step import (
        make_offpolicy_train_fns,
    )
    from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

    dev = torch.device(ctx.device)
    on_gpu = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_gpu else (lambda: None)
    set_f32_precision()
    raw, algo, get = _sizes(ctx.config, ctx.traffic, ctx.sizes)
    num_envs = get("num_envs")
    steps_per_iter, updates = get("steps_per_iter"), get("updates_per_iter")
    cfg = construct_env_config(raw)
    fs = cfg.frame_stack
    assets = load_assets(ctx.config["suite"], device=dev)
    agent = SAC(SACConfig(**algo), obs_channels=3 * fs)
    demo_fn = make_scripted_driver(cfg, assets)
    capacity = max(algo["buffer_size"] // num_envs, 256)
    init_fn, train_step = make_offpolicy_train_fns(
        cfg, agent, num_envs, buffer_capacity=capacity,
        steps_per_iter=steps_per_iter, updates_per_iter=updates,
        demo_fn=demo_fn, demo_steps=get("demo_warmup_steps"),
        demo_envs=get("demo_envs"), device=dev)

    env_seed = gen.stream_seed(ctx.seed, gen.ENV_STREAM)
    carry = init_fn(assets, env_seed)
    st = agent.state
    actor_sd = gen.npz_weights(
        os.path.join(manifest.ROOT, ctx.config["actor"]), dev)
    critic_sd = gen.fresh_weights(
        ((k, tuple(v.shape)) for k, v in st.critic.state_dict().items()),
        ctx.seed, dev)
    st.actor.load_state_dict(actor_sd)
    st.critic.load_state_dict(critic_sd)
    st.target_critic.load_state_dict(critic_sd)
    carry.env_steps = get("start_env_steps")
    gen.fill_ring(carry.buffer, get("start_env_steps") // num_envs,
                  ctx.seed, dev)
    state0, obs0 = carry.rollout.env_state, carry.rollout.obs_stack[:, -3:]
    if ctx.fault is not None:
        train_step = ctx.fault(train_step, agent)

    # the compared train steps: the first update's Adam state is read as
    # soon as it is there
    first: Dict[str, torch.Tensor] = {}
    update = agent.update

    def first_update(*args, **kwargs):
        out = update(*args, **kwargs)
        if not first:
            opt = agent.state.critic_opt
            beta1 = opt.param_groups[0]["betas"][0]
            for name, p in agent.state.critic.named_parameters():
                first[name] = opt.state[p]["exp_avg"].detach() / (1 - beta1)
        return out

    agent.update = first_update
    losses = []
    for _ in range(COMPARED_STEPS):
        carry, metrics = train_step(assets, carry)
        losses.append({k: float(metrics[k]) for k in LOSSES})
    agent.update = update
    changed = {n: p.detach().clone()
               for n, p in agent.state.critic.named_parameters()}
    sync()

    upd_events: List = []
    if ctx.trace and on_gpu:
        def timed_update(*args, **kwargs):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            out = update(*args, **kwargs)
            e1.record()
            upd_events.append((e0, e1))
            return out
        agent.update = timed_update

    setup_s = time.perf_counter() - ctx.t0
    with win.no_gc():
        t_start = time.perf_counter()
        stamps = [t_start]
        deadline = t_start + ctx.seconds
        while True:
            carry, _ = train_step(assets, carry)
            stamps.append(time.perf_counter())
            if stamps[-1] >= deadline:
                break
        sync()
        window_s = time.perf_counter() - t_start
    n = len(stamps) - 1
    agent.update = update
    transitions = n * steps_per_iter * num_envs
    r = {
        "setup_s": setup_s,
        "window_s": window_s,
        "steps": n,
        "attempted": transitions,
        "train_env_steps_per_s": transitions / window_s,
        "per_step_s": window_s / n,
        "memory_peak_bytes": (torch.cuda.max_memory_allocated(dev)
                              if on_gpu else 0),
        # the host's time of each train step's call (the host runs about
        # one step ahead of the device): where in the window a run was slow
        "step_ms_by_tenth": _tenths([(b - a) * 1e3 for a, b in
                                     zip(stamps, stamps[1:])]),
        "updates_per_train_step": updates,
        "env_steps_per_train_step": steps_per_iter,
    }
    if upd_events:
        ms = [a.elapsed_time(b) for a, b in upd_events]
        r["learner_update_ms"] = sum(ms) / len(ms)
        r["updates_timed"] = len(ms)

    if ctx.trace or on_gpu:
        def steps():
            nonlocal carry
            for _ in range(TRACE_TRAIN_STEPS):
                carry, _ = train_step(assets, carry)

        r["trace"] = _trace.summarize(*_trace.run_traced(steps,
                                                         ctx.trace_path))
        r["trace_steps"] = TRACE_TRAIN_STEPS
        r["train_step_device_ms"] = (r["trace"]["busy_s"] * 1e3
                                     / TRACE_TRAIN_STEPS)
    if ctx.trace:
        buf = carry.buffer
        cells = torch.remainder(
            buf.pos.long() - 1 - torch.arange(
                TRACE_TRAIN_STEPS * steps_per_iter, device=dev),
            buf.done.shape[1])
        r["traced_train"] = Traced(
            carry.rollout.env_state,
            int(buf.done[:, cells].sum()) / (num_envs * cells.numel()))
        r["critic_shapes"] = {k: tuple(v.shape) for k, v in
                              agent.state.critic.state_dict().items()}
        r["actor_shapes"] = {k: tuple(v.shape) for k, v in actor_sd.items()}
        r["batch_size"] = algo["batch_size"]
        r["obs_shape"] = (3 * fs, cfg.simulator.renderer.obs_res,
                          cfg.simulator.renderer.obs_res)

    del carry, agent, st, train_step, init_fn, demo_fn, assets
    if on_gpu:
        torch.cuda.empty_cache()
    r["ref"] = reference_readings(ctx, raw, algo, get, env_seed, state0, obs0,
                                  actor_sd, critic_sd, losses, first, changed)
    r["compared_steps"] = COMPARED_STEPS
    r["compared_done"] = 0
    return r


def reference_readings(ctx, raw, algo, get, env_seed, state0, obs0,
                       actor_sd, critic_sd, losses, first, changed) -> dict:
    """The reference's verdict on the first reset and the compared train
    steps; with ``ctx.control`` the control's readings too (the reference
    one precision lower in the program's place: float32 results rounded to
    bfloat16, the bfloat16 torsos' to float8 e5m2)."""
    from benchmark.reference import arrays as rarrays
    from benchmark.reference import config as rconfig
    from benchmark.reference.lowp import LowerPrecision

    dev = torch.device(ctx.device)
    rcfg = rconfig.env_config(raw)
    rassets = rarrays.load_assets(ctx.config["suite"], device=dev)
    args = (rcfg, rassets, algo, get, env_seed, ctx.seed, actor_sd,
            critic_sd, dev)
    ref = _follow(*args)
    start = compare.Tally()
    compare.add_reset(start, state0, obs0, ref["reset"])
    prog_change = {n: changed[n] - critic_sd[n] for n in changed}
    readings = training_readings(losses, ref["losses"], first, ref["first"],
                                 prog_change, ref["change"])
    readings.update(start.readings())
    out = {"program": readings, "cfg": rcfg, "assets": rassets}
    if ctx.control:
        rarrays.device_constant.cache_clear()
        try:
            with LowerPrecision(torch.bfloat16, torch.float8_e5m2):
                low = _follow(*args)
        finally:
            rarrays.device_constant.cache_clear()
        ctl = compare.Tally()
        compare.add_reset(ctl, low["reset"]["state"], low["reset"]["obs"],
                          ref["reset"])
        out["control"] = training_readings(
            low["losses"], ref["losses"], low["first"], ref["first"],
            low["change"], ref["change"])
        out["control"].update(ctl.readings())
    return out


def _follow(rcfg, rassets, algo, get, env_seed, seed, actor_sd, critic_sd,
            dev):
    """The reference's first reset and its ``COMPARED_STEPS`` train steps
    -> {"reset", "losses", "first" (the first update's critic gradients),
    "change" (the critic's change over the steps)}."""
    from benchmark.reference import buffer as rbuffer
    from benchmark.reference import demo as rdemo
    from benchmark.reference import env as renv
    from benchmark.reference import sac as rsac

    num_envs = get("num_envs")
    fs = rcfg.frame_stack
    res = rcfg.simulator.renderer.obs_res
    agent = rsac.SAC(rsac.SACConfig(**algo), actor_sd, critic_sd, dev,
                     obs_channels=3 * fs, obs_res=res)
    g = torch.Generator(device=dev).manual_seed(env_seed)
    first_reset = renv.reset(rcfg, rassets, num_envs, g)
    capacity = max(algo["buffer_size"] // num_envs, 256)
    buf = gen.fill_ring(
        rbuffer.create(num_envs, capacity, (3, res, res), device=dev),
        get("start_env_steps") // num_envs, seed, dev)
    carry = rsac.Carry(
        first_reset["state"], rsac.init_stack(first_reset["obs"], fs),
        buf, g, get("start_env_steps"))
    demo_fn = rdemo.make_scripted_driver(rcfg, rassets)
    losses = []
    for _ in range(COMPARED_STEPS):
        carry, metrics = rsac.train_step(
            rcfg, rassets, agent, carry, num_envs, get("steps_per_iter"),
            get("updates_per_iter"), demo_fn, get("demo_warmup_steps"),
            get("demo_envs"))
        losses.append({k: float(metrics[k]) for k in LOSSES})
    change = {n: p.detach() - critic_sd[n]
              for n, p in agent.critic.named_parameters()}
    return {"reset": first_reset, "losses": losses,
            "first": agent.first_critic_grads or {}, "change": change}


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               keep=None) -> float:
    """The worst leaf's |‖p‖ - ‖r‖| over max(‖r‖, the median leaf's ‖r‖)."""
    norms = {n: (float(torch.linalg.vector_norm(prog[n].float()))
                 if n in prog else 0.0,
                 float(torch.linalg.vector_norm(ref[n].float())))
             for n in ref}
    if not norms:
        return float("inf")
    ref_norms = sorted(r for _, r in norms.values())
    median = ref_norms[len(ref_norms) // 2]
    gaps = [abs(p - r) / max(r, median, 1e-30) for n, (p, r) in norms.items()
            if keep is None or n in keep]
    return max(gaps) if gaps else 0.0


def training_readings(losses, ref_losses, first, ref_first, prog_change,
                      ref_change) -> Dict[str, float]:
    loss_gap = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-30)
                   for p, r in zip(losses, ref_losses) for k in LOSSES)
    grad_norms = {n: float(torch.linalg.vector_norm(g.float()))
                  for n, g in ref_first.items()}
    med = sorted(grad_norms.values())[len(grad_norms) // 2] if grad_norms \
        else 0.0
    moving = {n for n, v in grad_norms.items() if v >= NOUGHT_GRAD * med}
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gaps(first, ref_first),
            "change_gap": _leaf_gaps(prog_change, ref_change, moving)}
