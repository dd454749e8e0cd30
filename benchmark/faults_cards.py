"""Faults across cards, planted under the timed path of a data-parallel
on-policy cell (``drivers/onpolicy.py``), for the tests and the readings
the cell's limits were set from: with any of them a run's ``correct`` has
to come out false. The benchmark's own runs never plant one.

    python3 -m benchmark.faults_cards --workload <cell> --seeds 11 12 13
        --fault NAME [NAME ...] [--seconds 2] [--control] [--one-card]

One JSON line per fault and seed: the program's readings with the fault
planted, and the cell's limits; with ``--control`` the same run also
takes the control's readings and the witness (the reference against
itself), which do not depend on the program; with ``--one-card`` every
rank runs on card 0 under gloo (the readings at the cell's size for a
quarter of the cards; nccl's sums replaced by gloo's). ``--fault none``
takes a sound run.

A fault is ``fault(agent, mesh) -> unplant``: called on every rank once
its agent and mesh are built, before the compared train step; it changes
what the port does from outside (the agent's ``_step``, a function of
``rl/ppo.py`` or of ``env/batched.py``) and ``unplant()`` puts it back.
"""

from __future__ import annotations

import argparse
import json
import sys


def allreduce_left_out(agent, mesh):
    """Each rank steps Adam on its own gradient: no all-reduce before the
    clip."""
    def own(loss, mesh=None):
        type(agent)._step(agent, loss, None)

    agent._step = own
    return lambda: delattr(agent, "_step")


def _swap(module, name, value):
    kept = getattr(module, name)
    setattr(module, name, value)
    return lambda: setattr(module, name, kept)


def advantages_per_rank(agent, mesh):
    """Each minibatch's advantages normalised over the rank's own rows, not
    over the minibatch of every rank."""
    from torchdriveenv_tpu_torch.rl import ppo

    normalized = ppo._normalized
    return _swap(ppo, "_normalized",
                 lambda adv, m, mesh: normalized(adv, adv.shape[0], None))


def rank_rows_dropped(agent, mesh):
    """The last rank's owned rows left out of every minibatch."""
    from torchdriveenv_tpu_torch.rl import ppo

    owned = ppo._owned_rows

    def dropped(idx, mesh, e):
        rows = owned(idx, mesh, e)
        return rows[:0] if mesh.rank == mesh.world - 1 else rows

    return _swap(ppo, "_owned_rows", dropped)


def reset_offset_left_out(agent, mesh):
    """The pooled reset's exchange between ranks left out: every rank's
    done envs take the pool's entries from 0, not after the done envs of
    the lower ranks."""
    import torch

    from torchdriveenv_tpu_torch.env import batched

    return _swap(batched, "offset_of",
                 lambda count, mesh: torch.zeros_like(count))


UPDATE_FAULTS = {"allreduce_left_out": allreduce_left_out,
                 "advantages_per_rank": advantages_per_rank,
                 "rank_rows_dropped": rank_rows_dropped}
CARD_FAULTS = dict(UPDATE_FAULTS, reset_offset_left_out=reset_offset_left_out)


def readings(workload: str, seed: int, seconds: float, device: str,
             fault: str, **extra) -> dict:
    from benchmark import run

    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds)])
    ctx = run.context(args, device, fault=CARD_FAULTS.get(fault), **extra)
    r = run.manifest.driver(ctx.config["driver"]).run(ctx)
    out = {"workload": workload, "seed": seed, "steps": r["steps"],
           "compared_steps": r["compared_steps"],
           "compared_done_envs": r["compared_done"], "fault": fault,
           "program": r["ref"]["program"], "limits": ctx.config["check"],
           "correct": all(r["ref"]["program"][k] <= lim
                          for k, lim in ctx.config["check"].items())}
    for k in ("control", "witness"):
        if k in r["ref"]:
            out[k] = r["ref"][k]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", nargs="+", required=True,
                    choices=sorted(CARD_FAULTS) + ["none"])
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--one-card", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from benchmark import run

    chips = 1 if args.one_card else run.manifest.cell(
        run.manifest.load_manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s)", file=sys.stderr)
        return run.EXIT_NO_CARD
    for fault in args.fault:
        for seed in args.seeds:
            print(json.dumps(readings(
                args.workload, seed, args.seconds, "cuda", fault,
                control=args.control,
                sizes={"ranks_on_one_card": True} if args.one_card else {})),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
