"""The readings a cell's limits are set from: for each seed, one run's set-up
and a short window at the cell's own size, then the program's readings
(sound runs: the lower readings) and the control's (the reference one
precision lower, every float32 result rounded to bfloat16 and every
bfloat16 one to float8, in the program's place: the upper readings), both
against the reference. With ``--fault NAME`` the program runs with that
fault of ``benchmark/faults.py`` planted, and its readings are the
fault's.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13
        [--seconds 2] [--fault NAME]

One JSON line per seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import faults, run


def readings(workload: str, seed: int, seconds: float, device: str,
             fault: str = None, **extra) -> dict:
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds)])
    ctx = run.context(args, device, control=fault is None, **extra)
    name = ctx.config["driver"]
    if fault is not None:
        kind = faults.ENV_FAULTS if name == "env" else faults.TRAIN_FAULTS
        ctx.fault = kind[fault]
    r = run.manifest.driver(name).run(ctx)
    return {"workload": workload, "seed": seed, "steps": r["steps"],
            "compared_steps": r["compared_steps"],
            "compared_done_envs": r["compared_done"],
            "fault": fault, "program": r["ref"]["program"],
            "control": r["ref"].get("control"),
            "limits": ctx.config["check"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None,
                    choices=sorted(set(faults.ENV_FAULTS)
                                   | set(faults.TRAIN_FAULTS)))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: the control is read on the card", file=sys.stderr)
        return run.EXIT_NO_CARD
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds, "cuda",
                                  args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
