"""The yardstick's reading of a ``torch.profiler`` trace: the device's busy
time (the union of its operations' intervals, a copy of the port's
``bench.py:profile_steps`` arithmetic), kernel launches, the device
operations that took most time, and the longest idle gaps named by what
the host was running when it launched the operation that ended each."""

from __future__ import annotations

import bisect
import json
import os
from typing import Callable, Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def run_traced(fn: Callable[[], None], trace_path: str):
    """fn() under torch.profiler (CPU and CUDA activity), ending in a
    synchronize -> (the window's wall seconds, the trace's events). The
    chrome trace is written to ``trace_path``, read and deleted."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    try:
        with open(trace_path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(trace_path)
    return window_s, events


def device_ops(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]


def busy_us(ops: List[dict]) -> float:
    """Microseconds in which at least one device operation ran: the union
    of their intervals."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in ops)
    busy, end = 0.0, -float("inf")
    for lo, hi in spans:
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy


def top_ops(ops: List[dict], n: int = 10) -> List[Tuple[str, float]]:
    """[[name, seconds]] of the device operations that took most time in
    all, summed by name."""
    by_name: Dict[str, float] = {}
    for e in ops:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    return sorted(by_name.items(), key=lambda kv: -kv[1])[:n]


def _host_op_at(cpu_ops: List[Tuple[float, float, str]], starts: List[float],
                ts: float) -> str:
    """The innermost host operation running at host time ``ts``."""
    best, best_dur = "host", float("inf")
    for i in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
        lo, dur, name = cpu_ops[i]
        if lo + dur >= ts and dur < best_dur:
            best, best_dur = name, dur
        if ts - lo > 5e6:           # no host op runs for 5 s
            break
    return best


def idle_gaps(events: List[dict], ops: List[dict], n: int = 10
              ) -> List[Tuple[str, float]]:
    """[[name, seconds]] of the ``n`` longest gaps in which no device
    operation ran, each named "before <host op>": the host operation that
    launched the device operation ending the gap."""
    spans = sorted(ops, key=lambda e: e["ts"])
    gaps, end = [], None
    for e in spans:
        if end is not None and e["ts"] > end:
            gaps.append((e["ts"] - end, e))
        end = e["ts"] + e["dur"] if end is None else max(end,
                                                          e["ts"] + e["dur"])
    gaps = sorted(gaps, key=lambda g: -g[0])[:n]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime"
                 and "correlation" in e.get("args", {})}
    cpu_ops = sorted((e["ts"], e["dur"], e["name"]) for e in events
                     if e.get("cat") == "cpu_op" and "dur" in e)
    starts = [c[0] for c in cpu_ops]
    out = []
    for gap_us, e in gaps:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        name = _host_op_at(cpu_ops, starts, ts) if ts is not None else "host"
        out.append((f"before {name}"[:120], gap_us * 1e-6))
    return out


def summarize(window_s: float, events: List[dict]) -> dict:
    """The readings the per-layer metrics and the result's ``device`` and
    ``breakdown`` take from one traced window."""
    ops = device_ops(events)
    kernels = [e for e in ops if e.get("cat") == "kernel"]
    return {
        "window_s": window_s,
        "busy_s": busy_us(ops) * 1e-6,
        "kernels": kernels,
        "breakdown": {"device_ops": [list(x) for x in top_ops(ops)],
                      "idle_gaps": [list(x) for x in idle_gaps(events, ops)]},
    }
