#!/usr/bin/env python3
"""Export the actor of a SAC checkpoint of the JAX package as a data file of
the PyTorch port.

    python tools/export_torch_actor.py \
        [--checkpoint artifacts/deliverable_sac_stage1_model_2000384] \
        [--out torchdriveenv_tpu_torch/assets/deliverable_sac_stage1_actor.npz]

Reads the Orbax checkpoint directory with orbax and numpy (no JAX program
runs), carries ``actor_params`` across with the port's
``models/convert.py`` and writes an ``.npz`` of f32 arrays under the
``state_dict`` keys of ``SquashedGaussianActor`` plus ``obs_res`` and
``frame_stack``. ``torchdriveenv_tpu_torch.models.load_actor`` reads it back.
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from torchdriveenv_tpu_torch.models import DELIVERABLE_ACTOR  # noqa: E402
from torchdriveenv_tpu_torch.models.convert import params_to_torch  # noqa: E402

DEFAULT_CHECKPOINT = os.path.join(
    ROOT, "artifacts", "deliverable_sac_stage1_model_2000384")


def restore(path: str):
    """The checkpoint's tree as nested dicts of numpy arrays."""
    import orbax.checkpoint as ocp
    return ocp.PyTreeCheckpointer().restore(os.path.abspath(path))


def actor_arrays(tree, obs_res: int, frame_stack: int):
    """What the ``.npz`` holds, from a restored ``SACState`` tree."""
    state = params_to_torch(tree["actor_params"], obs_res)
    arrays = {k: v.numpy().astype(np.float32) for k, v in state.items()}
    arrays["obs_res"] = np.asarray(obs_res, np.int32)
    arrays["frame_stack"] = np.asarray(frame_stack, np.int32)
    return arrays


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", default=DEFAULT_CHECKPOINT)
    ap.add_argument("--out", default=DELIVERABLE_ACTOR)
    ap.add_argument("--obs_res", type=int, default=64)
    ap.add_argument("--frame_stack", type=int, default=3)
    args = ap.parse_args()
    arrays = actor_arrays(restore(args.checkpoint), args.obs_res,
                          args.frame_stack)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez(args.out, **arrays)
    n = sum(a.size for a in arrays.values())
    print(f"wrote {args.out}: {len(arrays)} arrays, {n} values, "
          f"{os.path.getsize(args.out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
