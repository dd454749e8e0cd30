"""Distill the GRU NPC policy (``npc/policy_net.py``) from the deterministic
IDM route follower and write its weights (port of ``tools/distill_npc.py``).

The written weights make ``EnvConfig(npc_mode="policy")`` behave like the
rule controller; without ``--out`` they replace the shipped asset
``assets/npc_gru_v1.npz``. Elsewhere, load them with
``npc/policy_net.py:load_npc_policy(path)`` and hand them to
``BatchedEnv(..., npc_params=)`` or ``core.step(..., npc_params=)``.

    python -m torchdriveenv_tpu_torch.tools.distill_npc [--steps 1500]
        [--batch 256] [--lr 1e-3] [--out path.npz] [--device cpu]
"""

from __future__ import annotations

import argparse

from torchdriveenv_tpu_torch.maps.arrays import load_assets, resolve_device
from torchdriveenv_tpu_torch.npc import policy_net


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)

    assets = load_assets("train", device=resolve_device(args.device))
    # fresh weights and scenes, each from a generator seeded 0
    policy, loss = policy_net.distill(assets, steps=args.steps,
                                      batch=args.batch, lr=args.lr)
    path = policy_net.save_npc_policy(policy, args.out)
    print(f"distilled {args.steps} steps, final imitation MSE {loss:.4f} -> "
          f"{path}")
    return dict(path=path, policy=policy, loss=loss)


if __name__ == "__main__":
    main()
