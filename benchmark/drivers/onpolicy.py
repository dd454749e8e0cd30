"""The on-policy training driver: ``parallel/train_step.py``'s
``make_onpolicy_train_fns`` with the port's PPO, data parallel over the
cell's ``chips`` ranks as the training CLI runs under
``torch.distributed.run`` (``rl/train.py``): one process a card, nccl (gloo
without a card), every rank building its agent (``rl.train.build_agent``),
its mesh (``make_mesh``) and its train step.

The run's own process is rank 0 on card 0. It starts ranks 1 to W - 1 as
processes of this module (``python3 -m benchmark.drivers.onpolicy
--worker <spec>``) with torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``, ``OMP_NUM_THREADS=1``),
their output sent to its standard error, and kills them all when one
fails or the run overruns ``RUN_TIMEOUT_S``. A worker that finds ``jax``,
``jaxlib``, ``flax`` or ``torchdriveenv_tpu`` loaded exits with
``run.EXIT_BANNED``, and so does the run, printing no result.

Set-up: the port's assets, the agent fresh from the seed (its ``init``
through the train step's ``init_fn``, as the CLI's first train step has
it), the first reset from the seeded generator; under a mesh the net's
forward and backward at every owned-row count a minibatch can give the
rank (``owned_row_counts``, ``warm_row_counts``); then train steps up to and
including the compared one, the first that holds a time-limit truncation
(``compared_train_step``: train step 6 of the configuration), observed for
the check. The window: whole train steps until ``seconds`` have passed on
rank 0's clock (rank 0's verdict broadcast after each, the CLI's
``agree``), then an all-reduce and a ``synchronize``, so that the slowest
rank's time counts; the garbage collector off in every rank.
``env_steps_per_s`` is the global envs x env steps of the window's train
steps over its time. With ``trace``, one more train step runs with rank 0
under ``torch.profiler``; the per-layer metrics read its trace and the
span log it leaves in rank 0's process.

The check (after the window): every rank's parameters bit-equal to rank
0's after the compared train step and at the end (``rank_gap``); the first
reset and the ``SAMPLED_ENV_STEPS`` env steps of the compared train step
with the most done envs stepped by the reference (``benchmark/reference``)
over the global batch from the program's own state before each, with the
same actions and generator state, every rank's rows compared as the env
cells compare them; and from the gathered rollout, the weights and Adam
state before the update and the generator state its permutations come
from, ``benchmark/reference/ppo.py`` in one process: the rollout's values,
log-probs and bootstrapped rewards recomputed (``rollout_gap``), GAE from
them (``adv_gap``), then every gradient step from the program's weights
before it (``pg_loss_gap``, ``v_loss_gap``, ``grad_gap``, ``change_gap``);
``update_readings`` says how each is read.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from benchmark import compare, gen, manifest
from benchmark import window as win
from benchmark.drivers.env import Saved, _tenths
from benchmark.metrics import _trace

TRACE_TRAIN_STEPS = 1
SAMPLED_ENV_STEPS = 2
RUN_TIMEOUT_S = 1800.0       # the whole run, set-up and check included
GRACE_S = 60.0               # rank 0's time to fail on its own after a peer
PG_TIMEOUT_S = 900.0         # a collective's longest wait
WARM_SDS = 5.0               # owned-row counts warmed: mean +- this many sds
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
               "MASTER_PORT")
ROLLOUT_KEYS = ("obs", "action", "log_prob", "value", "reward", "done",
                "raw_reward")


def _sizes(config: dict, traffic: dict, sizes: dict):
    raw = manifest.merged(manifest.merged(config["env"],
                                          traffic.get("env", {})),
                          sizes.get("env", {}))
    algo = manifest.merged(config["algo"], sizes.get("algo", {}))
    return raw, algo, sizes.get("num_envs", config["num_envs"])


# ---- the ranks ------------------------------------------------------------

def _one_card(ctx) -> bool:
    """Every rank on card 0 under gloo (nccl refuses two ranks on one
    card): the check's readings of a four-card cell from one card, for the
    readings its limits are set from. The cell itself never runs so."""
    return bool(ctx.sizes.get("ranks_on_one_card"))


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _fault_name(fault) -> Optional[str]:
    """``module:function`` of a fault, as a worker imports it (the module
    by its import name where it runs as ``__main__``)."""
    if fault is None:
        return None
    spec = getattr(sys.modules[fault.__module__], "__spec__", None)
    module = spec.name if spec is not None else fault.__module__
    return f"{module}:{fault.__qualname__}"


def _fault_of(name: Optional[str]):
    if name is None:
        return None
    module, attr = name.split(":")
    return getattr(importlib.import_module(module), attr)


class _Ranks:
    """Ranks 1 .. W-1 as processes of this module, watched from a thread:
    when one exits non-zero, or the run passes its deadline, every rank is
    killed and, unless rank 0's own call ends within ``GRACE_S`` (a gloo
    peer's collective fails at once, an nccl one would wait for the group's
    timeout), rank 0's process exits with that code."""

    def __init__(self, ctx, world: int):
        self.world, self.port = world, _free_port()
        spec = {"workload": ctx.workload, "seed": ctx.seed,
                "seconds": ctx.seconds, "trace": ctx.trace,
                "device": ctx.device, "sizes": ctx.sizes,
                "control": ctx.control, "fault": _fault_name(ctx.fault)}
        base = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
        base.update(OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
                    MASTER_PORT=str(self.port), WORLD_SIZE=str(world))
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "benchmark.drivers.onpolicy", "--worker",
             json.dumps(spec)], cwd=manifest.ROOT,
            env=dict(base, RANK=str(r),
                     LOCAL_RANK="0" if _one_card(ctx) else str(r)),
            stdout=sys.stderr.fileno(), stderr=sys.stderr.fileno())
            for r in range(1, world)]
        self.done = threading.Event()
        self.deadline = time.monotonic() + RUN_TIMEOUT_S + 2 * ctx.seconds
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        while not self.done.is_set():
            codes = [p.poll() for p in self.procs]
            bad = [c for c in codes if c]
            late = time.monotonic() > self.deadline
            if bad or late:
                self.kill()
                print(f"onpolicy: a rank exited {bad[0]}" if bad else
                      "onpolicy: the run overran its time", file=sys.stderr,
                      flush=True)
                if not self.done.wait(GRACE_S):
                    os._exit(bad[0] if bad else 124)
                return
            self.done.wait(0.5)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def join(self) -> List[int]:
        """Every worker's exit code, once all have ended."""
        codes = []
        for p in self.procs:
            try:
                codes.append(p.wait(timeout=max(
                    self.deadline - time.monotonic(), 1.0)))
            except subprocess.TimeoutExpired:
                self.kill()
                codes.append(124)
        self.done.set()
        return codes


@contextlib.contextmanager
def _launch_env(world: int, port: int):
    """torchrun's variables for rank 0 in this process, restored after."""
    kept = {k: os.environ.get(k) for k in LAUNCH_VARS}
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        yield
    finally:
        for k, v in kept.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run(ctx) -> dict:
    """One run of an on-policy cell (rank 0) -> the readings
    ``benchmark.run`` turns into the result's line."""
    world = ctx.chips
    ranks = _Ranks(ctx, world)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)          # OMP_NUM_THREADS=1, as torchrun
        with _launch_env(world, ranks.port):
            r = _rank_run(ctx)
    except BaseException:
        ranks.kill()
        ranks.done.set()
        raise
    finally:
        torch.set_num_threads(threads)
    codes = ranks.join()
    bad = [c for c in codes if c]
    if bad:
        print(f"onpolicy: a rank exited {bad[0]}: no result",
              file=sys.stderr)
        raise SystemExit(bad[0])
    return r


def worker_main(spec: dict) -> int:
    """Rank ``RANK`` of a run that rank 0 started."""
    from benchmark import run as brun

    parent = os.getppid()

    def orphaned():
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(1.0)

    threading.Thread(target=orphaned, daemon=True).start()
    args = brun.parse(["--workload", spec["workload"], "--seed",
                       str(spec["seed"]), "--seconds", str(spec["seconds"]),
                       "--trace", str(int(spec["trace"]))])
    ctx = brun.context(args, spec["device"], sizes=spec["sizes"],
                       control=spec["control"],
                       fault=_fault_of(spec["fault"]))
    _rank_run(ctx)
    banned = brun.banned_modules()
    if banned:
        print(f"rank {os.environ['RANK']} loaded " + ", ".join(banned),
              file=sys.stderr)
        return brun.EXIT_BANNED
    return 0


# ---- what the check observes ---------------------------------------------

def _clone(tree):
    from torchdriveenv_tpu_torch.parallel.mesh import map_tensors
    return map_tensors(lambda x: x.detach().clone(), tree)


def _adam_state(opt, named) -> dict:
    """Adam's step count and moments by parameter name, on the host."""
    out = {"step": 0, "exp_avg": {}, "exp_avg_sq": {}}
    for n, p in named:
        s = opt.state.get(p)
        if s:
            out["step"] = int(s["step"])
            out["exp_avg"][n] = s["exp_avg"].detach().cpu().clone()
            out["exp_avg_sq"][n] = s["exp_avg_sq"].detach().cpu().clone()
    return out


class Probe:
    """Watches the compared train step from outside the program's code.

    Its env steps (around the train step's ``step_fn``): the
    ``SAMPLED_ENV_STEPS`` with the most done envs over every rank are kept
    for the env check (the state and generator state before, the actions,
    the output), and of every step the termination and truncation masks;
    around the agent's ``value``, the terminal stacks of the truncated envs
    and the last stack. The update (around ``rl/ppo.py``'s names): its
    inputs, GAE, Adam's state before it, each gradient step's loss parts
    (``mean_over``) and, on a rank that ``keeps`` them, each step's clipped
    gradient and the weights after it (``apply_grads``), on the host."""

    def __init__(self, agent, mesh=None, keep: bool = True):
        self.agent, self.mesh, self.keep = agent, mesh, keep
        self.on = False
        self.saved: List[Saved] = []
        self.done = 0.0                # done envs in the kept env steps
        self._best: List = []          # (done, k, Saved), most done first
        self.flags: List = []          # (terminated, truncated) a step
        self.finals: List = []         # (step, local rows, terminal stacks)
        self._truncated = None
        self.last_obs = None
        self.update_in: Dict = {}
        self.gae = None
        self.adam: Dict = {}
        self.parts: List[torch.Tensor] = []
        self.grads: List[List[torch.Tensor]] = []
        self.after: List[List[torch.Tensor]] = []

    def wrap_env(self, step_fn):
        def step(state, actions, g):
            if not self.on:
                return step_fn(state, actions, g)
            before, gs = _clone(state), g.get_state()
            out = step_fn(state, actions, g)
            done = (out.terminated | out.truncated).sum().float().reshape(1)
            if self.mesh is not None:
                dist.all_reduce(done)
            self._best.append((float(done.item()), len(self.flags),
                               Saved(before, gs, actions.detach().clone(),
                                     _clone(out))))
            self._best.sort(key=lambda x: (-x[0], x[1]))
            del self._best[SAMPLED_ENV_STEPS:]
            self.flags.append((out.terminated.clone(), out.truncated.clone()))
            self._truncated = out.truncated
            return out
        return step

    @contextlib.contextmanager
    def watching(self, ppo_module):
        agent = self.agent
        update, value = agent.update, agent.value
        compute_gae, mean_over, apply_grads = (
            ppo_module.compute_gae, ppo_module.mean_over,
            ppo_module.apply_grads)

        def watched_value(obs):
            out = value(obs)
            if self._truncated is None:          # the rollout's last stack
                self.last_obs = obs.detach().clone()
            else:                                # a step's terminal stacks
                rows = torch.nonzero(self._truncated)[:, 0]
                self.finals.append((len(self.flags) - 1, rows,
                                    obs[rows].detach().clone()))
                self._truncated = None
            return out

        def gae(*args, **kwargs):
            out = compute_gae(*args, **kwargs)
            self.gae = tuple(x.detach().clone() for x in out)
            return out

        def watched_update(rollout, last_value, generator=None, **kwargs):
            self.update_in = {"rollout": rollout, "last_value": last_value,
                              "gen_state": generator.get_state()}
            if self.keep:
                self.adam = _adam_state(agent.state.opt,
                                        agent.state.net.named_parameters())
            return update(rollout, last_value, generator=generator, **kwargs)

        def watched_mean(x, count, mesh):
            out = mean_over(x, count, mesh)
            self.parts.append(out.detach().clone())
            return out

        def watched_apply(opt, params, grads):
            if self.keep:
                self.grads.append([g.detach().to("cpu", copy=True)
                                   for g in grads])
            apply_grads(opt, params, grads)
            if self.keep:
                self.after.append([p.detach().to("cpu", copy=True)
                                   for p in params])

        self.on = True
        with _swapped(agent, update=watched_update, value=watched_value), \
                _swapped(ppo_module, compute_gae=gae, mean_over=watched_mean,
                         apply_grads=watched_apply):
            try:
                yield self
            finally:
                self.on = False
                self.saved = [x[2] for x in sorted(self._best,
                                                   key=lambda x: x[1])]
                self.done = sum(x[0] for x in self._best)
                self._best = []


@contextlib.contextmanager
def _swapped(obj, **attrs):
    """``obj``'s attributes set to ``attrs`` inside the block, each put back
    as it was after (an instance attribute that was not there is deleted
    again, so the class's method shows through)."""
    kept = {k: obj.__dict__[k] for k in attrs if k in vars(obj)}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k in attrs:
            if k in kept:
                setattr(obj, k, kept[k])
            else:
                delattr(obj, k)


# ---- one rank -------------------------------------------------------------

def _barrier(mesh, dev):
    if mesh is not None:
        t = torch.ones(1, device=dev)
        dist.all_reduce(t)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rank_run(ctx) -> Optional[dict]:
    """This rank's run, in the process group the launch variables name
    (joined here, left at the end); rank 0 returns the readings, the
    others None."""
    from torchdriveenv_tpu_torch.parallel import mesh as pm

    joined = (not dist.is_initialized()
              and pm.maybe_init_distributed(
                  backend="gloo" if _one_card(ctx) else None,
                  timeout_s=PG_TIMEOUT_S))
    try:
        return _train_and_check(ctx)
    finally:
        if joined:
            dist.destroy_process_group()


def compared_train_step(max_environment_steps: int, n_steps: int) -> int:
    """The first train step that holds a time-limit truncation: the
    compared one, so that the rollout's bootstrap and the pool's burst of
    resets are in the check."""
    return (max_environment_steps - 1) // n_steps


def owned_row_counts(n_rows: int, batch: int, share: float,
                     sds: float = WARM_SDS) -> range:
    """The numbers of a minibatch's ``batch`` rows, drawn without
    replacement from ``n_rows``, that fall in a rank's ``share`` of them:
    those within ``sds`` standard deviations of the mean (at 5, every
    count but for a chance of ~6e-7 a minibatch)."""
    mean = batch * share
    sd = math.sqrt(batch * share * (1 - share) * (n_rows - batch)
                   / max(n_rows - 1, 1))
    return range(max(1, math.floor(mean - sds * sd)),
                 min(batch, math.ceil(mean + sds * sd)) + 1)


def warm_row_counts(net, obs_shape, counts, dev) -> None:
    """The net's forward and backward (its parameters' gradients, not
    applied) at each of ``counts`` rows: every minibatch shape a rank can
    own met once in set-up rather than first inside the window, where
    cuDNN would pick and build the convolutions' plans for it."""
    x = torch.zeros((max(counts),) + tuple(obs_shape), dtype=torch.uint8,
                    device=dev)
    params = list(net.parameters())
    for k in counts:
        mu, log_std, value = net(x[:k])
        loss = mu.float().sum() + log_std.float().sum() + value.float().sum()
        torch.autograd.grad(loss, params, allow_unused=True)


def _train_and_check(ctx) -> Optional[dict]:
    from torchdriveenv_tpu_torch.config import (
        BaselineAlgorithm,
        construct_env_config,
    )
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.parallel import mesh as pm
    from torchdriveenv_tpu_torch.parallel import train_step as ts
    from torchdriveenv_tpu_torch.rl import ppo as ppo_module
    from torchdriveenv_tpu_torch.rl.train import build_agent
    from torchdriveenv_tpu_torch.utils import spans
    from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

    dev = torch.device(ctx.device)
    on_gpu = dev.type == "cuda"
    set_f32_precision()
    raw, algo, num_envs = _sizes(ctx.config, ctx.traffic, ctx.sizes)
    cfg = construct_env_config(raw)
    fs = cfg.frame_stack
    agent, on_policy = build_agent(BaselineAlgorithm(ctx.config["algorithm"]),
                                   obs_channels=3 * fs, algo_kwargs=algo)
    if not on_policy:
        raise ValueError("the on-policy driver runs PPO or A2C")
    mesh = pm.make_mesh(num_envs)
    rank = 0 if mesh is None else mesh.rank
    assets = load_assets(ctx.config["suite"], device=dev)
    n_steps = agent.cfg.n_steps
    probe = Probe(agent, mesh, keep=rank == 0)
    make_env_fns = ts.make_env_fns

    def observed_env_fns(*args, **kwargs):
        reset_fn, step_fn = make_env_fns(*args, **kwargs)
        return reset_fn, probe.wrap_env(step_fn)

    ts.make_env_fns = observed_env_fns
    try:
        init_fn, train_step = ts.make_onpolicy_train_fns(
            cfg, agent, num_envs, device=dev, mesh=mesh)
        env_seed = gen.stream_seed(ctx.seed, gen.ENV_STREAM)
        carry = init_fn(assets, env_seed)
        state0 = _clone(carry.rollout.env_state)
        obs0 = carry.rollout.obs_stack[:, -3:].clone()
        if mesh is not None:
            t_warm = time.perf_counter()
            counts = owned_row_counts(n_steps * num_envs,
                                      agent.cfg.batch_size,
                                      (mesh.hi - mesh.lo) / num_envs)
            warm_row_counts(agent.state.net,
                            carry.rollout.obs_stack.shape[1:], counts, dev)
            if rank == 0:
                print(f"onpolicy: {len(counts)} owned-row counts "
                      f"{counts.start}-{counts.stop - 1} warmed in "
                      f"{time.perf_counter() - t_warm:.1f} s",
                      file=sys.stderr, flush=True)
        stamps = [time.perf_counter()]
        for _ in range(compared_train_step(cfg.max_environment_steps,
                                           n_steps)):
            carry, _ = train_step(assets, carry)
            _barrier(mesh, dev)
            stamps.append(time.perf_counter())
        net = agent.state.net
        before = {n: p.detach().clone() for n, p in net.named_parameters()}
        unplant = (ctx.fault(agent, mesh) if ctx.fault is not None
                   else None)
        with probe.watching(ppo_module):
            carry, _ = train_step(assets, carry)
        after = {n: p.detach().clone() for n, p in net.named_parameters()}
        _barrier(mesh, dev)
        stamps.append(time.perf_counter())
        if rank == 0:
            print("onpolicy set-up train steps ms " + json.dumps(
                [round((b - a) * 1e3, 1) for a, b in zip(stamps, stamps[1:])]),
                file=sys.stderr, flush=True)

        setup_s = time.perf_counter() - ctx.t0
        with win.no_gc():
            _barrier(mesh, dev)
            t_start = time.perf_counter()
            stamps = [t_start]
            while True:
                carry, _ = train_step(assets, carry)
                stamps.append(time.perf_counter())
                if pm.agree(stamps[-1] - t_start >= ctx.seconds, mesh):
                    break
            _barrier(mesh, dev)
            window_s = time.perf_counter() - t_start
        n = len(stamps) - 1

        traced = None
        if ctx.trace:
            def steps():
                nonlocal carry
                for _ in range(TRACE_TRAIN_STEPS):
                    carry, _ = train_step(assets, carry)

            if rank == 0:
                spans.clear()
                if on_gpu:
                    traced = _trace.summarize(*_trace.run_traced(
                        steps, ctx.trace_path))
                else:
                    with spans.recording():
                        steps()
            else:
                steps()
            _barrier(mesh, dev)
        if unplant is not None:
            unplant()
    finally:
        ts.make_env_fns = make_env_fns

    peak = torch.tensor([float(torch.cuda.max_memory_allocated(dev))
                         if on_gpu else 0.0], device=dev)
    if mesh is not None:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX)
    final = {n: p.detach().clone() for n, p in net.named_parameters()}
    env_state = carry.rollout.env_state
    del carry, train_step, init_fn
    if on_gpu:
        torch.cuda.empty_cache()

    steps_per_train = n_steps * num_envs
    r = {
        "setup_s": setup_s,
        "window_s": window_s,
        "steps": n,
        "attempted": n * steps_per_train,
        "env_steps_per_s": win.rate(n * steps_per_train, window_s),
        "per_step_s": window_s / n,
        # each window train step's host time (rank 0 waits for every rank
        # at the end of each)
        "step_ms_by_tenth": _tenths([(b - a) * 1e3 for a, b in
                                     zip(stamps, stamps[1:])]),
        "memory_peak_bytes": int(peak.item()),
        "world": 1 if mesh is None else mesh.world,
        "num_envs": num_envs,
        "env_steps_per_train_step": n_steps,
        "algo": dict(algo),
        "obs_shape": (3 * fs, cfg.simulator.renderer.obs_res,
                      cfg.simulator.renderer.obs_res),
        "net_shapes": {k: tuple(v.shape) for k, v in before.items()},
    }
    if ctx.trace:
        if traced is not None:
            r["trace"] = traced
        r["trace_steps"] = TRACE_TRAIN_STEPS
        r["traced_state"] = env_state

    r["compared_steps"] = 1
    r["compared_done"] = int(probe.done)
    r["ref"] = check(ctx, mesh, raw, algo, num_envs, env_seed, state0, obs0,
                     probe, before, after, final, dev)
    return r if rank == 0 else None


# ---- the check -------------------------------------------------------------

def to_rank0(x: torch.Tensor, mesh, dim: int = 0) -> Optional[torch.Tensor]:
    """The global tensor of which every rank holds its env rows ``x``
    (along ``dim``), on rank 0 (None elsewhere): each rank's block
    broadcast in turn, so no rank but 0 holds more than one block."""
    if mesh is None:
        return x
    as_u8 = x.dtype == torch.bool
    x = (x.view(torch.uint8) if as_u8 else x).contiguous()
    shape = list(x.shape)
    shape[dim] *= mesh.world
    out = torch.empty(shape, dtype=x.dtype, device=x.device) \
        if mesh.rank == 0 else None
    for src in range(mesh.world):
        buf = x if mesh.rank == src else torch.empty_like(x)
        dist.broadcast(buf, src=src)
        if out is not None:
            out.narrow(dim, src * x.shape[dim], x.shape[dim]).copy_(buf)
        del buf
    if out is not None and as_u8:
        out = out.view(torch.bool)
    return out


def rows_to_rank0(x: torch.Tensor, mesh) -> Optional[torch.Tensor]:
    """Every rank's rows ``x`` (any number a rank) joined in rank order on
    rank 0 (None elsewhere)."""
    if mesh is None:
        return x
    blocks = []
    for src in range(mesh.world):
        count = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        dist.broadcast(count, src=src)
        buf = x.contiguous() if mesh.rank == src else torch.empty(
            (int(count.item()),) + tuple(x.shape[1:]), dtype=x.dtype,
            device=x.device)
        dist.broadcast(buf, src=src)
        if mesh.rank == 0:
            blocks.append(buf)
    return torch.cat(blocks) if mesh.rank == 0 else None


def tree_to_rank0(tree, mesh):
    from torchdriveenv_tpu_torch.parallel.mesh import map_tensors
    if mesh is None:
        return tree
    local = mesh.local_envs
    return map_tensors(lambda x: to_rank0(x, mesh) if x.dim() >= 1
                       and x.shape[0] == local else x, tree)


def rank_gap_of(params: Dict[str, torch.Tensor], mesh) -> float:
    """The largest |p - p on rank 0| over every parameter and rank."""
    if mesh is None:
        return 0.0
    flat = torch.cat([p.reshape(-1).float() for p in params.values()])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    gap = (flat - ref).abs().max().reshape(1)
    dist.all_reduce(gap, op=dist.ReduceOp.MAX)
    return float(gap.item())


def _rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """max |p - r| over max |r|."""
    if p.shape != r.shape:
        return float("inf")
    if not r.numel():
        return 0.0
    scale = float(r.abs().max())
    return float((p.float() - r.float()).abs().max()) / max(scale, 1e-30)


def _leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]
               ) -> Dict[str, float]:
    """Each leaf's ||p - r|| / ||r||, against its own norm (the policy
    head's gradient is a thousandth of the torso's, so a floor at the
    median leaf would hide it)."""
    gaps = {}
    for n, r in ref.items():
        if n not in prog:
            gaps[n] = float("inf")
            continue
        diff = float(torch.linalg.vector_norm(
            prog[n].to(r.device, torch.float32) - r.float()))
        norm = float(torch.linalg.vector_norm(r.float()))
        gaps[n] = (diff / norm if norm > 0 else
                   (0.0 if diff == 0 else float("inf")))
    return gaps


def _steps_gap(prog: List[Dict], ref: List[Dict]) -> float:
    """Each leaf over every gradient step together, ||p - r|| / ||r|| of
    its sequence (a step where a leaf's gradient passes near 0 weighs
    little on either side), the worst leaf."""
    if len(prog) != len(ref) or not ref:
        return float("inf")
    diff: Dict[str, float] = {}
    norm: Dict[str, float] = {}
    for p, r in zip(prog, ref):
        for n, x in r.items():
            y = p[n].to(x.device, torch.float32) if n in p else None
            d = (float(torch.linalg.vector_norm(y - x.float())) ** 2
                 if y is not None else float("inf"))
            diff[n] = diff.get(n, 0.0) + d
            norm[n] = norm.get(n, 0.0) + float(
                torch.linalg.vector_norm(x.float())) ** 2
    return max((diff[n] / norm[n]) ** 0.5 if norm[n] > 0 else
               (0.0 if diff[n] == 0 else float("inf")) for n in norm)


def update_readings(prog: dict, ref: dict) -> dict:
    """The rollout's and the update's numbers. ``prog`` and ``ref`` each
    hold the rollout's ``value``, ``log_prob``, ``reward`` (the truncated
    envs' bootstrap in it) and ``last_value``, the GAE ``advantages`` and
    ``returns``, and each gradient step's ``losses`` ((steps, 4): loss,
    pg, v, ent), clipped gradient (``grads``) and change of the weights
    (``changes``), by name. The reference computes the rollout's numbers
    from the weights before the update and its GAE from them; each of its
    gradient steps starts from the program's weights before that step
    (``reference/ppo.py``'s ``forced``), so no reading compounds rounding.

    - ``rollout_gap``: the value, log-prob, reward and last value, the
      largest gap over the largest magnitude of each;
    - ``adv_gap``: the advantages and returns, likewise;
    - ``pg_loss_gap`` / ``v_loss_gap``: the policy and value parts of
      every step's loss, each over its own largest magnitude;
    - ``grad_gap`` / ``change_gap``: every step's clipped gradient and
      change of the weights, each leaf's ||p - r|| / ||r|| over the
      steps together, the worst leaf."""
    return {
        "rollout_gap": max(_rel_gap(prog[k], ref[k]) for k in
                           ("value", "log_prob", "reward", "last_value")),
        "adv_gap": max(_rel_gap(prog["advantages"], ref["advantages"]),
                       _rel_gap(prog["returns"], ref["returns"])),
        "pg_loss_gap": _rel_gap(prog["losses"][:, 1], ref["losses"][:, 1]),
        "v_loss_gap": _rel_gap(prog["losses"][:, 2], ref["losses"][:, 2]),
        "grad_gap": _steps_gap(prog["grads"], ref["grads"]),
        "change_gap": _steps_gap(prog["changes"], ref["changes"]),
    }


def _detail(prog: dict, ref: dict) -> dict:
    """Where the update's numbers come from, for standard error: the first
    steps' loss parts of both sides, and each leaf's gap over the steps of
    the gradient and of the change, and its worst step's."""
    def leaves(ps, rs):
        out = {}
        for n in rs[0]:
            seq = _steps_gap([{n: p[n]} for p in ps], [{n: r[n]} for r in rs])
            step = max(_leaf_gaps({n: p[n]}, {n: r[n]})[n]
                       for p, r in zip(ps, rs))
            out[n] = [round(seq, 6), round(step, 6)]
        return out
    first = [[round(float(x), 6) for x in row] for row in
             torch.stack([prog["losses"][:8, 1:3].cpu(),
                          ref["losses"][:8, 1:3].cpu()], 1).reshape(-1, 4)]
    return {"pg_v_first_steps": first,
            "pg_absmax": float(ref["losses"][:, 1].abs().max()),
            "v_absmax": float(ref["losses"][:, 2].abs().max()),
            "grad": leaves(prog["grads"], ref["grads"]),
            "change": leaves(prog["changes"], ref["changes"])}


def _program_side(probe, names, before, rollout, last_value, advantages,
                  returns, parts, cfg) -> dict:
    """The program's numbers, as ``update_readings`` takes them."""
    device = rollout["value"].device
    grads = [dict(zip(names, g)) for g in probe.grads]
    weights = [before] + [dict(zip(names, w)) for w in probe.after]
    changes = [{n: w1[n].to(device) - w0[n].to(device) for n in names}
               for w0, w1 in zip(weights, weights[1:])]
    pg, v, ent = -parts[:, 0], parts[:, 1], parts[:, 2]
    loss = pg + cfg.vf_coef * v - cfg.ent_coef * ent
    return {"value": rollout["value"], "log_prob": rollout["log_prob"],
            "reward": rollout["reward"], "last_value": last_value,
            "advantages": advantages, "returns": returns,
            "losses": torch.stack([loss, pg, v, ent], 1),
            "grads": grads, "changes": changes, "forced": weights[:-1]}


def check(ctx, mesh, raw, algo, num_envs, env_seed, state0, obs0, probe,
          before, after, final, dev) -> Optional[dict]:
    """The check's readings on rank 0 (None on the other ranks); every
    rank takes part in its collectives. The env side first, then the
    update's: rank 0 holds one side's global tensors at a time."""
    from benchmark.reference import arrays as rarrays
    from benchmark.reference import config as rconfig
    from benchmark.reference import env as renv
    from benchmark.reference import ppo as rppo
    from benchmark.reference.lowp import LowerPrecision

    main = mesh is None or mesh.rank == 0
    rank_gap = max(rank_gap_of(after, mesh), rank_gap_of(final, mesh))
    state0 = tree_to_rank0(state0, mesh)
    obs0 = to_rank0(obs0, mesh)
    steps = [Saved(tree_to_rank0(s.state, mesh), s.gen_state,
                   to_rank0(s.actions, mesh), tree_to_rank0(s.out, mesh))
             for s in probe.saved]
    probe.saved = []
    if main:
        rcfg = rconfig.env_config(raw)
        rassets = rarrays.load_assets(ctx.config["suite"], device=dev)

        def gen_at(state):
            g = torch.Generator(device=dev)
            g.set_state(state)
            return g

        def env_side():
            g = torch.Generator(device=dev).manual_seed(env_seed)
            return (renv.reset(rcfg, rassets, num_envs, g),
                    [renv.step(rcfg, rassets, renv.state_from(s.state),
                               s.actions, gen_at(s.gen_state),
                               with_final_obs=True) for s in steps])

        t_env = time.perf_counter()
        first, refs = env_side()
        t_env = time.perf_counter() - t_env
        env_readings = _env_readings(state0, obs0, [s.out for s in steps],
                                     first, refs)
        if ctx.control:
            rarrays.device_constant.cache_clear()
            try:
                with LowerPrecision(torch.bfloat16):
                    low_first, low_steps = env_side()
            finally:
                rarrays.device_constant.cache_clear()
            from benchmark.drivers.env import _as_output
            env_control = _env_readings(
                low_first["state"], low_first["obs"],
                [_as_output(x) for x in low_steps], first, refs)
        del state0, obs0, steps, first, refs
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    update_in = probe.update_in
    rollout = {k: to_rank0(update_in["rollout"][k], mesh, dim=1)
               for k in ROLLOUT_KEYS}
    last_value = to_rank0(update_in["last_value"], mesh)
    advantages, returns = (to_rank0(x, mesh, dim=1) for x in probe.gae)
    terminated, truncated = (to_rank0(torch.stack(x), mesh, dim=1)
                             for x in zip(*probe.flags))
    lo = 0 if mesh is None else mesh.lo
    final_at = rows_to_rank0(torch.cat(
        [torch.stack([torch.full_like(rows, t), rows + lo], 1)
         for t, rows, _ in probe.finals]), mesh)
    final_obs = rows_to_rank0(torch.cat([x for _, _, x in probe.finals]),
                              mesh)
    last_obs = to_rank0(probe.last_obs, mesh)
    parts = torch.stack(probe.parts).reshape(-1, 3)
    if mesh is not None:
        dist.all_reduce(parts)        # each rank's share -> the global mean
    gen_state = update_in["gen_state"]
    del update_in
    probe.update_in, probe.gae, probe.parts = {}, None, []
    probe.flags, probe.finals, probe.last_obs = [], [], None
    if not main:
        return None

    pcfg = rppo.PPOConfig(**algo)
    names = list(before)
    prog = _program_side(probe, names, before, rollout, last_value,
                         advantages, returns, parts, pcfg)
    shape = dict(obs_channels=3 * rcfg.frame_stack,
                 obs_res=rcfg.simulator.renderer.obs_res)

    def reference(forced=prog["forced"], row_order=None):
        net = rppo.network(before, dev, **shape)
        out = rppo.rollout(pcfg, net, rollout["obs"], rollout["action"],
                           rollout["raw_reward"], terminated, truncated,
                           final_at, final_obs, last_obs)
        out["advantages"], out["returns"] = rppo.gae(
            out["reward"], out["value"], rollout["done"], out["last_value"],
            pcfg.gamma, pcfg.gae_lambda)
        out.update(rppo.update(pcfg, net, probe.adam, rollout["obs"],
                               rollout["action"], rollout["log_prob"],
                               advantages, returns, gen_state, dev,
                               forced=forced, row_order=row_order))
        out["weights"] = {n: p.detach().clone()
                          for n, p in net.named_parameters()}
        return out

    t_up = time.perf_counter()
    ref_update = reference()
    program = update_readings(prog, ref_update)
    program.update(env_readings)
    program["rank_gap"] = rank_gap
    detail = {"program": _detail(prog, ref_update),
              "compared_bootstrapped": int(
                  (truncated & ~terminated).sum()),
              "check_s": {"env": t_env, "update": time.perf_counter() - t_up}}
    out = {"program": program, "cfg": rcfg, "assets": rassets}
    if ctx.control:
        rarrays.device_constant.cache_clear()
        try:
            with LowerPrecision(torch.bfloat16, torch.float8_e5m2):
                low_update = reference()
        finally:
            rarrays.device_constant.cache_clear()
        out["control"] = dict(update_readings(low_update, ref_update),
                              rank_gap=0.0, **env_control)
        detail["control"] = _detail(low_update, ref_update)
        out["witness"] = detail["witness"] = _witness(
            reference, before, after, ctx.seed)
    print("onpolicy check detail " + json.dumps(detail), file=sys.stderr,
          flush=True)
    return out


def _witness(reference, before, after, seed) -> dict:
    """What the update's change over all its gradient steps reads when each
    step starts from the learner's own weights: the reference against
    itself with each minibatch's rows in another order (rounding alone),
    and the program against the reference, each leaf's ||p - r|| / ||r||
    of the change."""
    free = reference(forced=None)
    g = torch.Generator().manual_seed(seed)
    reordered = reference(forced=None, row_order=g)

    def change(w):
        return {n: w[n].float() - before[n].float() for n in before}

    def leaves(p, r):
        return {n: round(v, 6) for n, v in
                _leaf_gaps(change(p), change(r)).items()}
    return {"reordered_vs_reference": leaves(reordered["weights"],
                                             free["weights"]),
            "program_vs_reference": leaves(after, free["weights"])}


def _env_readings(state0, obs0, outs, first, refs) -> dict:
    """``flipped_envs``, ``float_gap`` and ``pixels_off`` of a first reset
    and the compared steps' outputs against the reference's."""
    tally = compare.Tally()
    compare.add_reset(tally, state0, obs0, first)
    for out, ref in zip(outs, refs):
        compare.add_step(tally, out, ref)
    return tally.readings()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2 or argv[0] != "--worker":
        print("usage: python3 -m benchmark.drivers.onpolicy --worker <spec>",
              file=sys.stderr)
        return 2
    return worker_main(json.loads(argv[1]))


if __name__ == "__main__":
    sys.exit(main())
