"""Env rollout example (port of ``examples/rollout_example.py``, the
reference's ``examples/waypoint_suite_env_example.ipynb`` as a script):
roll a validation episode of ``torchdriveenv-torch-v0`` with the constant
action [1, 0] until it ends, and write a video of the 512 px egocentric
view over a 120 m field of view. Needs gymnasium.

    python -m torchdriveenv_tpu_torch.examples.rollout_example
        [--out rendered_video.avi] [--suite val] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="rendered_video.avi")
    ap.add_argument("--suite", default="val")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)
    set_f32_precision()

    from torchdriveenv_tpu_torch.env.gym_adapter import TorchGymEnv

    cfg = EnvConfig(seed=42, render_mode="video", video_filename=args.out,
                    video_res=512, video_fov=120.0)
    env = TorchGymEnv(cfg, data=args.suite, device=args.device)
    env.reset()
    total, steps = 0.0, 0
    while True:
        _, reward, terminated, truncated, info = env.step(
            np.array([1.0, 0.0], np.float32))
        total += reward
        steps += 1
        if terminated or truncated:
            break
    print(f"episode ended after {steps} steps, return {total:.1f}, "
          f"info: { {k: np.asarray(v).tolist() for k, v in info.items()} }")
    env.close()
    print(f"video written to {args.out}")
    return dict(steps=steps, total=total, info=info)


if __name__ == "__main__":
    main()
