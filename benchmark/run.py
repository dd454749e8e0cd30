"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (imports, the kernel library from the port's build cache, assets,
the first reset, warm-up), then a window of ``--seconds``, then the check
of what the window produced against the plain reference. ``--trace 0``
prints the cell's end-to-end metrics; ``--trace 1`` also traces a short
window with ``torch.profiler`` and prints the per-layer metrics (a
training cell traces its train step after the window in both modes).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with ``--trace 1``
``breakdown``), then ``checks``: each number compared, with its limit,
also the last lines of standard error. With no CUDA card, or fewer than
the cell asks for, the run exits with code 3 and prints no result; when
JAX or the JAX package was loaded, with code 4.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """``time.perf_counter()`` at the process's start (Linux: its start
    time in ``/proc``); the module's import time where that is unknown."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


T0 = _process_start()

# every cache a run writes sits at a fixed path inside the checkout, so only
# a checkout's first run builds or compiles
_CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), ".bench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

from benchmark import manifest  # noqa: E402

# top-level module names a run must not load, compared whole
BANNED = ("jax", "jaxlib", "flax", "torchdriveenv_tpu")
EXIT_NO_CARD, EXIT_BANNED = 3, 4


@dataclasses.dataclass
class Context:
    workload: str
    seed: int
    seconds: float
    trace: bool
    device: str
    config: dict
    traffic: dict
    chips: int = 1
    t0: float = T0
    # test-only: smaller sizes, a fault planted under the timed path, the
    # control's readings
    sizes: Dict = dataclasses.field(default_factory=dict)
    fault: Optional[Callable] = None
    control: bool = False
    trace_path: str = os.path.join(_CACHE, "trace.json")


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name is banned."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in BANNED})


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def context(args, device: str, **extra) -> Context:
    m = manifest.load_manifest()
    cell = manifest.cell(m, args.workload)
    return Context(workload=args.workload, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace),
                   device=device, chips=cell["chips"],
                   config=manifest.config(m, cell["config"]),
                   traffic=manifest.traffic(cell["traffic"]), **extra)


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def result(ctx: Context, r: dict) -> dict:
    """The result's line from a driver's readings."""
    import torch

    m = manifest.load_manifest()
    limits = ctx.config["check"]
    checks = {k: {"value": r["ref"]["program"][k], "limit": lim}
              for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    metrics = {}
    if ctx.trace:
        for spec in manifest.per_layer(m, ctx.workload):
            value = manifest.metric_reader(spec["name"]).read(r)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    else:
        # a device-trace metric has no reading where there is no card
        for spec in manifest.end_to_end(m, ctx.workload):
            if spec["name"] in r:
                metrics[spec["name"]] = {"value": r[spec["name"]],
                                         "unit": spec["unit"]}
    on_gpu = torch.device(ctx.device).type == "cuda"
    device = {
        "platform": "gpu" if on_gpu else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
        "count": ctx.chips,
        "memory_peak_bytes": r["memory_peak_bytes"],
    }
    out = {"correct": correct, "attempted": r["attempted"], "failed": 0,
           "metrics": metrics, "device": device}
    if ctx.trace:
        device["busy_s"] = r["trace"]["busy_s"]
        device["window_s"] = r["trace"]["window_s"]
        out["breakdown"] = r["trace"]["breakdown"]
    out["setup_s"] = r["setup_s"]
    out["steps"] = r["steps"]
    for k in ("window_s", "step_ms_median", "step_ms_by_tenth",
              "updates_timed"):
        if k in r:
            out[k] = r[k]
    out["compared_steps"] = r["compared_steps"]
    out["compared_done_envs"] = r["compared_done"]
    if on_gpu:
        out["card"] = card_line()
    out["checks"] = checks
    return out


def run_cell(ctx: Context) -> dict:
    """Set up, measure, check -> the result's line (no look for a card)."""
    r = manifest.driver(ctx.config["driver"]).run(ctx)
    return result(ctx, r)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    ctx = context(args, "cuda")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < ctx.chips:
        print(f"{args.workload} needs {ctx.chips} CUDA card(s), found "
              f"{found}: no result", file=sys.stderr)
        return EXIT_NO_CARD
    os.makedirs(_CACHE, exist_ok=True)
    line = run_cell(ctx)
    banned = banned_modules()
    if banned:
        print("a run loaded " + ", ".join(banned) + ": no result",
              file=sys.stderr)
        return EXIT_BANNED
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
