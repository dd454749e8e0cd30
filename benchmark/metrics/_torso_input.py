"""The yardstick's reading of the torso input kernel in a trace
(``csrc/torso_input.cu``, ``torso_input_kernel``: a uint8 frame stack to
the bf16 channels-last ``obs / 255`` the torsos run on): its events, the
rows each pass wrote, and the least bytes of a pass, each byte of the
stack read once and each bf16 value written once. A launch's grid runs
one column of blocks a row of the stack (``grid.x`` is its batch), so
each event carries its own rows and a lost event loses its bytes with its
time. No such kernel in the trace reads nothing."""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

from benchmark.metrics import _costs

KERNEL = "torso_input_kernel"
BYTES_PER_VALUE = 1 + 2         # a uint8 read, a bf16 written


def events(r) -> Optional[List[dict]]:
    """The kernel's events in the traced window, None where there are
    none or no trace."""
    t = r.get("trace")
    if not t:
        return None
    ev = [e for e in t["kernels"] if KERNEL in e["name"]]
    return ev or None


def least_bytes(rows: int, obs_shape: Sequence[int]) -> int:
    """Bytes one pass over ``rows`` stacks of ``obs_shape`` (C, H, W) must
    move."""
    return rows * math.prod(obs_shape) * BYTES_PER_VALUE


def per_update(r, updates: int) -> Optional[float]:
    """The kernel's runs over the traced updates."""
    ev = events(r)
    if ev is None or not updates:
        return None
    return len(ev) / updates


def roofline(r) -> Optional[float]:
    """100 x the least time of the traced passes (their bytes at the HBM
    rate) over the kernel's device time."""
    ev, shape = events(r), r.get("obs_shape")
    if ev is None or shape is None:
        return None
    rows = [e.get("args", {}).get("grid", [None])[0] for e in ev]
    dur_us = sum(e["dur"] for e in ev)
    if None in rows or dur_us <= 0:
        return None
    least_s = (sum(least_bytes(n, shape) for n in rows)
               / _costs.H100_PEAK_HBM_BYTES)
    return 100.0 * least_s / (dur_us * 1e-6)


def sac_updates(r) -> int:
    """The SAC updates of the traced train steps."""
    return r.get("updates_per_train_step", 0) * r.get("trace_steps", 0)


def ppo_gradient_steps(r) -> int:
    """The PPO gradient steps of the traced train steps: epochs x
    minibatches of the rollout's rows."""
    algo = r.get("algo")
    if not algo or not r.get("trace_steps"):
        return 0
    rows = r["env_steps_per_train_step"] * r["num_envs"]
    return (algo["n_epochs"] * (rows // algo["batch_size"])
            * r["trace_steps"])
