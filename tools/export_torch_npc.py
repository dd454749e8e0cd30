#!/usr/bin/env python3
"""Export the JAX package's GRU NPC policy as a data file of the PyTorch
port.

    python tools/export_torch_npc.py \
        [--params torchdriveenv_tpu/assets/npc_gru_v1.msgpack] \
        [--out torchdriveenv_tpu_torch/assets/npc_gru_v1.npz]

Reads the Flax msgpack with ``flax.serialization.msgpack_restore`` (no JAX
program runs), carries it across with the port's
``models/convert.py:npc_params_to_torch`` and writes an ``.npz`` of f32
arrays under the ``state_dict`` keys of ``NpcGRU``.
``torchdriveenv_tpu_torch.npc.policy_net.load_npc_policy`` reads it back.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torchdriveenv_tpu_torch.models.convert import npc_params_to_torch  # noqa: E402
from torchdriveenv_tpu_torch.npc.policy_net import NPC_POLICY  # noqa: E402

DEFAULT_PARAMS = os.path.join(ROOT, "torchdriveenv_tpu", "assets",
                              "npc_gru_v1.msgpack")


def restore(path: str):
    """The msgpack's tree as nested dicts of numpy arrays."""
    from flax import serialization
    with open(path, "rb") as f:
        return serialization.msgpack_restore(f.read())


def npc_arrays(tree):
    """What the ``.npz`` holds, from a restored parameter tree."""
    return {k: v.numpy().astype(np.float32)
            for k, v in npc_params_to_torch(tree).items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--params", default=DEFAULT_PARAMS)
    ap.add_argument("--out", default=NPC_POLICY)
    args = ap.parse_args()
    arrays = npc_arrays(restore(args.params))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"wrote {args.out}: {len(arrays)} arrays, {n} values, "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
