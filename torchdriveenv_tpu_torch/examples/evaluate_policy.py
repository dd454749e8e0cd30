"""Policy evaluation (port of ``examples/evaluate_policy.py``, the
reference's ``examples/waypoint_suite_evaluation.ipynb`` as a script): load
a training checkpoint and roll deterministic episodes on the 5 validation
scenarios, reporting the 9-metric benchmark set and the per-case success.

Accepts a model-only save (``models/<run>/model_<N>``, which
``rl/train.py`` writes at ``model_save_freq``, or the BC warm start of
``tools/bc_pretrain.py``) or a full-carry checkpoint (``full_latest``; pass
``--full_checkpoint``). Both are ``torch.save`` files.

    python -m torchdriveenv_tpu_torch.examples.evaluate_policy \
        --checkpoint models/<run>/model_<N> [--algorithm sac] [--episodes 10]
        [--npc_mode policy] [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from torchdriveenv_tpu_torch.config import BaselineAlgorithm, EnvConfig
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import load_assets, resolve_device
from torchdriveenv_tpu_torch.models.policies import scale_action
from torchdriveenv_tpu_torch.rl.evaluate import make_evaluator
from torchdriveenv_tpu_torch.rl.train import build_agent, restore_checkpoint
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

EVAL_SEED = 123


def load_agent_state(checkpoint: str, agent, env_cfg: EnvConfig,
                     full_checkpoint: bool = False, device=None):
    """Initialise ``agent`` on ``device`` (default: ``env_cfg.device``, then
    the GPU) and load its state from a model-only save, or from the
    ``"agent"`` entry of a full-carry checkpoint. Returns ``agent.state``."""
    dev = resolve_device(device if device is not None else env_cfg.device)
    agent.init(obs_res=env_cfg.simulator.renderer.obs_res, device=dev)
    tree = restore_checkpoint(checkpoint, dev)
    agent.load_state(tree["agent"] if full_checkpoint else tree)
    return agent.state


def evaluate(checkpoint: str, algorithm: str = "sac", episodes: int = 10,
             suite: str = "val", env_cfg: Optional[EnvConfig] = None,
             full_checkpoint: bool = False, device=None) -> Dict[str, float]:
    """The evaluator's metrics of ``checkpoint`` as floats, read from the
    device once. On the validation suite episodes are pinned round-robin to
    its cases (at least one each), so the result carries
    ``success_case_{i}`` and ``reached_case_{i}``."""
    env_cfg = env_cfg or EnvConfig()
    dev = resolve_device(device if device is not None else env_cfg.device)
    assets = load_assets(suite, device=dev)
    agent, _ = build_agent(BaselineAlgorithm(algorithm),
                           obs_channels=3 * env_cfg.frame_stack)
    load_agent_state(checkpoint, agent, env_cfg, full_checkpoint, dev)
    reset_fn, step_fn = make_env_fns(env_cfg, assets, render=True)
    generator = torch.Generator(device=dev).manual_seed(EVAL_SEED)

    def policy(_, stack):
        out = agent.select_action(stack, generator, deterministic=True)
        return out[0] if isinstance(out, tuple) else out

    cases = n_cases = None
    if suite == "val":
        n_cases = int(assets.suite.case_town.shape[0])
        episodes = max(episodes, n_cases)
        cases = np.arange(episodes) % n_cases
    ev = make_evaluator(reset_fn, step_fn, policy, env_cfg.frame_stack,
                        scale_action, max_steps=env_cfg.max_environment_steps,
                        cases=cases, n_cases=n_cases)
    metrics = ev(generator, episodes)
    values = torch.stack([v.to(torch.float32) for v in metrics.values()])
    return dict(zip(metrics, values.cpu().tolist()))


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--algorithm", default="sac")
    ap.add_argument("--episodes", type=int, default=10)
    ap.add_argument("--suite", default="val")
    ap.add_argument("--full_checkpoint", action="store_true")
    ap.add_argument("--npc_mode", default=None, choices=["route", "policy"],
                    help="override the NPC behavioral model (the IDM route "
                    "follower or the distilled GRU policy)")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)
    set_f32_precision()

    env_cfg = EnvConfig(npc_mode=args.npc_mode) if args.npc_mode else None
    metrics = evaluate(args.checkpoint, args.algorithm, args.episodes,
                       args.suite, env_cfg=env_cfg,
                       full_checkpoint=args.full_checkpoint,
                       device=args.device)
    for k, v in sorted(metrics.items()):
        print(f"eval/{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
