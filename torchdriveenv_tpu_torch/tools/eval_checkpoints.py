"""Evaluate every ``model_<step>`` checkpoint of a run on the validation
suite (per-case success and reached breakdown) and write a JSON table: the
best-checkpoint selector of the training recipe (port of
``tools/eval_checkpoints.py``).

    python -m torchdriveenv_tpu_torch.tools.eval_checkpoints \
        --ckpt_dir models/<run> --episodes 50 [--algorithm sac]
        [--last_n 4] [--out sweep.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.examples.evaluate_policy import evaluate
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision


def model_names(ckpt_dir: str, last_n=None) -> List[str]:
    """The ``model_<step>`` files of ``ckpt_dir`` by step (the last
    ``last_n`` of them when given)."""
    names = sorted((n for n in os.listdir(ckpt_dir) if n.startswith("model_")),
                   key=lambda n: int(n.split("_")[1]))
    return names[-last_n:] if last_n else names


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ckpt_dir", required=True)
    ap.add_argument("--algorithm", default="sac")
    ap.add_argument("--episodes", type=int, default=50)
    ap.add_argument("--suite", default="val")
    ap.add_argument("--npc_mode", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--last_n", type=int, default=None,
                    help="only the N highest-step checkpoints")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)
    set_f32_precision()

    env_cfg = EnvConfig(npc_mode=args.npc_mode) if args.npc_mode else None
    rows = []
    for n in model_names(args.ckpt_dir, args.last_n):
        m = evaluate(os.path.join(args.ckpt_dir, n), args.algorithm,
                     args.episodes, args.suite, env_cfg=env_cfg,
                     device=args.device)
        rows.append({"checkpoint": n, "step": int(n.split("_")[1]), **m})
        per_case = " ".join(f"c{i}={m[f'success_case_{i}']:.2f}"
                            for i in range(5) if f"success_case_{i}" in m)
        print(f"{n}: success={m['success_percentage']:.3f} "
              f"reach={m['reached_waypoint_num']:.2f} "
              f"len={m['mean_episode_length']:.1f} {per_case}", flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"-> {args.out}")
    return rows


if __name__ == "__main__":
    main()
