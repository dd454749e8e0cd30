"""The port held to the JAX package's own outputs, on any device.

``assets/jax_reference_v1.npz`` holds what the JAX package computes on
small inputs (its recorder is ``tests/test_torch_card_reference.py``; see
there for the layout). ``run_reference_checks(assets, device)`` replays its
draws and actions through ``core.reset_from_draws``, ``core.step`` and
``env.batched._consume_pool`` on ``device`` and compares:

  ints and bools exactly; floats at the golden tolerance (atol 1e-4, rtol
  1e-5); the GRU's hidden state at atol 1e-5, rtol 1e-5.

A rollout counts discrete flips by env: an agent whose heading error lies
within ``FOLD_EPS`` of the NPC controller's fold at pi/2 (an ulp decides
which way it steers), or a flag that differs (collision, offroad, traffic
light, waypoint, terminated, truncated, or any other integer or bool).
From its first flip on, an env's floats are no longer compared. A check is
ok when every compared float is within its tolerance and the flipped envs
are within the check's bound. Nothing raises: the callers assert.

``FlipTracker`` is the same comparison for any two runs of one rollout.
Where both runs are the port's (``chip_smoke.py`` ``[parity]`` holds the
card to the CPU with it), each run's own NPC decisions (``npc_decisions``:
the control-field cell, the side of the fold, the obstacle and stopline
followed) are compared as discrete quantities too, in place of the
nearness to the fold.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional

import numpy as np
import torch

import torchdriveenv_tpu_torch
from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import batched, core
from torchdriveenv_tpu_torch.maps.arrays import (
    Assets,
    MapArrays,
    _nearest_index,
    resolve_device,
    sample_npc_field,
)
from torchdriveenv_tpu_torch.npc import route_follow as rf

REFERENCE_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.realpath(__file__))), "assets",
    "jax_reference_v1.npz")
# the JAX package's golden trajectories, read in place
GOLDEN_PATH = os.path.join(torchdriveenv_tpu_torch._data_path[0],
                           "golden_trajectories_v1.npz")
GOLDEN_TOL = dict(atol=1e-4, rtol=1e-5)
HIDDEN_TOL = dict(atol=1e-5, rtol=1e-5)
FOLD_EPS = 1e-5
# tools/golden_trajectories.py: 5 validation cases x 3 scripts, seed 7
GOLDEN_SEED = 7
GOLDEN_CASES = 5
GOLDEN_SCRIPTS = ("cruise", "weave", "brake")
GOLDEN_KEYS = ("ego", "reward", "terminated", "truncated", "target_idx")
# the traffic rollouts: 8 envs (keys 100-107), 10 steps of uniform actions
TRAFFIC_STEPS = 10
TRAFFIC_ACTION_SEED = 11
TRAFFIC_MODES = {"route": {}, "policy": {"npc_mode": "policy"},
                 "ego_only": {"ego_only": True}}
ROLLOUT_MODES = ("route", "policy")
# flipped envs allowed: what the CPU tests allow
GOLDEN_FLIP_BOUND = 0
TRAFFIC_FLIP_BOUND = 1
# info entries whose sign is a flag: > 0 means the infraction happened
INFRACTIONS = ("offroad", "collision", "traffic_light_violation")


def _probe(maps: MapArrays, state: core.EnvState, npc_mode: str):
    """The NPC controller's probe point and unfolded heading error per
    agent, as ``npc_mode``'s controller computes them: the route follower
    probes at the lane offset to the agent's right (``npc/route_follow.py``),
    the GRU's features to its left (``npc/policy_net.py``)."""
    st = state.agent_states
    px, py, psi, v = st[..., 0], st[..., 1], st[..., 2], st[..., 3]
    fx, fy = torch.cos(psi), torch.sin(psi)
    lx, ly = -torch.sin(psi), torch.cos(psi)
    look = torch.clamp(v * 0.6, min=3.0)
    side = rf.LANE_OFFSET if npc_mode == "policy" else -rf.LANE_OFFSET
    probe = torch.stack([px + fx * look + lx * side,
                         py + fy * look + ly * side], dim=-1)
    dir_tgt, _, _ = sample_npc_field(maps, state.town, probe)
    return probe, rf._wrap(dir_tgt - psi)


def _npcs(state: core.EnvState) -> torch.Tensor:
    """(B, A) present agents other than the ego (slot 0)."""
    npc = state.present.clone()
    npc[:, 0] = False
    return npc


def fold_agents(cfg: EnvConfig, maps: MapArrays,
                state: core.EnvState) -> torch.Tensor:
    """(B, A) bool: present NPCs whose heading error lies within FOLD_EPS of
    +-pi/2, where an ulp decides which way the controller steers."""
    _, herr = _probe(maps, state, cfg.npc_mode)
    return (torch.abs(torch.abs(herr) - math.pi / 2) < FOLD_EPS) & _npcs(state)


def npc_decisions(cfg: EnvConfig, maps: MapArrays,
                  state: core.EnvState) -> Dict[str, torch.Tensor]:
    """The NPC controller's discrete decisions in the step from ``state``,
    per present NPC (-1 / False in the other slots): the control-field
    cell its probe rounds to (an ulp of cos / sin can move a probe across a
    cell's edge), the side of the heading fold, the obstacle it follows and
    the stopline it brakes for (-1: none; a gap or an offset at a range's
    edge decides), and in route mode whether that stopline is nearer than
    the obstacle. Two runs that differ here part for good."""
    probe, herr = _probe(maps, state, cfg.npc_mode)
    _, i, j = _nearest_index(maps, maps.npc_field, state.town, probe)
    npc = _npcs(state)
    none = torch.full_like(i, -1)
    t = state.time0 + state.step_idx.to(torch.float32) * cfg.simulator.dt
    gap_ij, _ = rf.obstacle_gaps(state.agent_states, state.agent_attrs,
                                 state.present)
    sl_gap = rf.stopline_gaps(maps, state.town, t, state.agent_states,
                              state.agent_attrs)

    def nearest(gaps):
        return torch.where(torch.isfinite(gaps.amin(dim=-1)) & npc,
                           gaps.argmin(dim=-1).to(i.dtype), none)

    out = {"decision/cell": torch.where(npc[..., None],
                                        torch.stack([i, j], dim=-1),
                                        none[..., None]),
           "decision/fold": (torch.abs(herr) > math.pi / 2) & npc,
           "decision/leader": nearest(gap_ij),
           "decision/stopline": nearest(sl_gap)}
    if cfg.npc_mode != "policy":
        out["decision/light_first"] = (sl_gap.amin(dim=-1)
                                       < gap_ij.amin(dim=-1)) & npc
    return out


def step_outputs(state: core.EnvState, reward, terminated, truncated,
                 info) -> Dict[str, torch.Tensor]:
    """One step's outputs by name, each with a leading env axis."""
    out = {f"state/{k}": getattr(state, k) for k in state._fields()}
    out.update(reward=reward, terminated=terminated, truncated=truncated)
    out.update({f"info/{k}": v for k, v in info.items()})
    return out


def _tol(name: str) -> dict:
    return HIDDEN_TOL if name.endswith("npc_hidden") else GOLDEN_TOL


def _per_env(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


@dataclasses.dataclass
class FlipTracker:
    """Compares two runs of one rollout step by step (``got`` and ``want``:
    dicts of named tensors, each with a leading env axis; integer and bool
    tensors are discrete) and keeps the flipped envs out of the float
    comparison from their first flip on. ``flips_by`` counts the envs each
    discrete quantity flipped first."""

    envs: int
    bound: int
    flipped: torch.Tensor = None
    flips_by: Dict[str, int] = dataclasses.field(default_factory=dict)
    fold_agents: int = 0
    max_err: float = 0.0
    max_err_name: str = ""
    float_fail: Optional[str] = None
    steps: int = 0

    def __post_init__(self):
        self.flipped = torch.zeros(self.envs, dtype=torch.bool)

    def update(self, got: Dict[str, torch.Tensor],
               want: Dict[str, torch.Tensor],
               fold: Optional[torch.Tensor] = None) -> None:
        """``fold``: (B, A) agents near the fold in the state this step
        started from (``fold_agents``), or None."""
        live = ~self.flipped
        flags = {}
        floats = {}
        for name, w in want.items():
            g = got[name].detach().cpu()
            w = w.detach().cpu()
            if g.shape != w.shape:
                self.float_fail = f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}"
                return
            if w.is_floating_point():
                floats[name] = (g, w)
                if name.split("/")[-1] in INFRACTIONS:
                    flags[name] = (g > 0) != (w > 0)
            else:
                flags[name] = _per_env(g != w).any(dim=1)
        if fold is not None:
            fold = fold.detach().cpu()
            self.fold_agents += int(fold[live].sum())
            flags["fold (within FOLD_EPS)"] = fold.any(dim=1)
        for name, f in flags.items():
            new = f & live & ~self.flipped
            if new.any():
                self.flips_by[name] = self.flips_by.get(name, 0) + int(new.sum())
                self.flipped |= new
        keep = ~self.flipped
        for name, (g, w) in floats.items():
            if not keep.any():
                break
            g, w = _per_env(g[keep]).double(), _per_env(w[keep]).double()
            t = _tol(name)
            err = float((g - w).abs().max())
            if err > self.max_err:
                self.max_err, self.max_err_name = err, name
            over = (g - w).abs() > t["atol"] + t["rtol"] * w.abs()
            if over.any() and self.float_fail is None:
                env = int(torch.nonzero(keep)[int(torch.nonzero(
                    over.any(dim=1))[0])])
                self.float_fail = (f"step {self.steps} {name}: env {env}, "
                                   f"max |diff| {err:.3g}")
        self.steps += 1

    def result(self) -> dict:
        n = int(self.flipped.sum())
        return dict(ok=self.float_fail is None and n <= self.bound,
                    max_err=self.max_err, max_err_name=self.max_err_name,
                    flipped_envs=n, flip_bound=self.bound, envs=self.envs,
                    steps=self.steps, flips_by=dict(self.flips_by),
                    fold_agents=self.fold_agents, float_fail=self.float_fail)


class _Ref:
    """The reference file's arrays under a prefix, as tensors on a device."""

    def __init__(self, data, device):
        self.data, self.device = data, device

    def tensor(self, key):
        return torch.as_tensor(np.asarray(self.data[key]), device=self.device)

    def group(self, prefix) -> Dict[str, torch.Tensor]:
        p = prefix + "/"
        return {k[len(p):]: self.tensor(k) for k in self.data.files
                if k.startswith(p)}

    def state(self, prefix) -> core.EnvState:
        p = prefix + "/"
        return core.EnvState.from_numpy(
            {k[len(p):]: self.data[k] for k in self.data.files
             if k.startswith(p)}, device=self.device)

    def draws(self, prefix) -> core.ResetDraws:
        return core.ResetDraws(**self.group(prefix))


def _reset_check(ref: _Ref, cfg: EnvConfig, assets: Assets, draws_key: str,
                 state_key: str) -> dict:
    got = core.reset_from_draws(cfg, assets, ref.draws(draws_key))
    want = ref.group(state_key)
    tr = FlipTracker(envs=got.town.shape[0], bound=0)
    tr.update({k: getattr(got, k) for k in want}, want)
    return tr.result()


def _golden_check(ref: _Ref, assets: Assets) -> dict:
    """The 15 scripts of 60 ego-only steps from the JAX reset states,
    against the JAX package's golden file."""
    cfg = EnvConfig(ego_only=True, seed=GOLDEN_SEED)
    reset = ref.state("golden/reset")
    n = GOLDEN_CASES * len(GOLDEN_SCRIPTS)
    rows = torch.arange(GOLDEN_CASES, device=ref.device).repeat_interleave(
        len(GOLDEN_SCRIPTS))
    state = reset.take(rows)
    acts = torch.stack([ref.tensor(f"golden/actions/{s}")
                        for s in GOLDEN_SCRIPTS] * GOLDEN_CASES, dim=1)
    golden = np.load(GOLDEN_PATH)
    names = [f"case{c}_{s}" for c in range(GOLDEN_CASES)
             for s in GOLDEN_SCRIPTS]
    want_all = {k: torch.stack([torch.as_tensor(golden[f"{p}_{k}"])
                                for p in names]) for k in GOLDEN_KEYS}
    tr = FlipTracker(envs=n, bound=GOLDEN_FLIP_BOUND)
    for t in range(acts.shape[0]):
        state, r, term, trunc, _ = core.step(cfg, assets, state, acts[t])
        got = dict(ego=state.agent_states[:, 0], reward=r, terminated=term,
                   truncated=trunc, target_idx=state.target_idx)
        tr.update(got, {k: v[:, t] for k, v in want_all.items()})
    return tr.result()


def _traffic_check(ref: _Ref, assets: Assets, mode: str) -> dict:
    """10 steps of 8 traffic envs from the JAX reset states."""
    cfg = EnvConfig(**TRAFFIC_MODES[mode])
    state = ref.state(f"traffic/reset/{mode}")
    acts = ref.tensor("traffic/actions")
    want_all = ref.group(f"traffic/{mode}")
    tr = FlipTracker(envs=state.town.shape[0], bound=TRAFFIC_FLIP_BOUND)
    for t in range(acts.shape[0]):
        fold = fold_agents(cfg, assets.maps, state)
        with torch.no_grad():
            out = core.step(cfg, assets, state, acts[t])
        state = out[0]
        tr.update(step_outputs(*out), {k: v[t] for k, v in want_all.items()},
                  fold)
    return tr.result()


def _pool_check(ref: _Ref, assets: Assets) -> dict:
    """The pool's states from its draws, then the done envs' consumption
    of the JAX pool (bit-equal) and of the port's own pool."""
    cfg = EnvConfig(reset_pool=int(ref.tensor("pool/fresh/town").shape[0]))
    nxt, done = ref.state("pool/next"), ref.tensor("pool/done")
    fresh = core.reset_from_draws(cfg, assets, ref.draws("pool/draws"))
    res = _reset_check(ref, cfg, assets, "pool/draws", "pool/fresh")
    want = ref.group("pool/out")
    exact, idx = batched._consume_pool(nxt, done, ref.state("pool/fresh"))
    bit_equal = all(torch.equal(getattr(exact, k), want[k]) for k in want)
    out, own_idx = batched._consume_pool(nxt, done, fresh)
    tr = FlipTracker(envs=done.shape[0], bound=0)
    tr.update({k: getattr(out, k) for k in want}, want)
    consumed = tr.result()
    idx_equal = (torch.equal(idx, ref.tensor("pool/idx").to(idx.dtype))
                 and torch.equal(own_idx, idx))
    return dict(consumed, ok=consumed["ok"] and res["ok"] and bit_equal
                and idx_equal, max_err=max(consumed["max_err"],
                                           res["max_err"]),
                pool_reset=res, bit_equal=bit_equal, idx_equal=idx_equal,
                done=int(done.sum()), pool=cfg.reset_pool)


def run_reference_checks(assets: Assets, device=None,
                         path: str = REFERENCE_PATH) -> Dict[str, dict]:
    """Every check of the module docstring on ``device`` (default: the
    GPU); ``assets``: the validation suite's, on that device. -> {check:
    {ok, max_err, flipped_envs, flip_bound, fold_agents, ...}}."""
    dev = resolve_device(device)
    if assets.device.type != dev.type:
        raise ValueError(f"assets are on {assets.device}, the checks on {dev}")
    ref = _Ref(np.load(path), dev)
    out = {"reset_golden": _reset_check(
        ref, EnvConfig(ego_only=True, seed=GOLDEN_SEED), assets,
        "golden/draws", "golden/reset")}
    out["golden"] = _golden_check(ref, assets)
    for mode, kw in TRAFFIC_MODES.items():
        out[f"reset_{mode}"] = _reset_check(ref, EnvConfig(**kw), assets,
                                            "traffic/draws",
                                            f"traffic/reset/{mode}")
    for mode in ROLLOUT_MODES:
        out[f"traffic_{mode}"] = _traffic_check(ref, assets, mode)
    out["pool"] = _pool_check(ref, assets)
    return out
