"""Behavior-cloning pretrain: fit the SAC actor to the scripted
demonstration driver (``rl/demo.py``) and write a model-only checkpoint for
``rl.train --init_model`` (port of ``tools/bc_pretrain.py``).

Rolls the scripted driver through the real env (every step rendered by the
rasterizer kernel), keeps (frame stack, normalized action) pairs on the
device, and trains the actor on them: mse(tanh(mu), a_demo) plus a small
pull of log_std toward ``BC_LOG_STD``. The critic, its targets and every
optimizer stay as ``SAC`` initialises them (the actor's Adam state too, as
the JAX tool re-initialises it); log_alpha starts at log(``--init_alpha``),
low, so that early entropy pressure does not blow the cloned policy apart
before the critic warms up.

Why (``TRAINING.md``): at SB3's defaults the env's reward optimum is fast
but fatal waypoint chasing, so pure SAC converges away from the success
metric. Cloning first puts the policy in the surviving basin; SAC then
improves the reward from there.

    python -m torchdriveenv_tpu_torch.tools.bc_pretrain --envs 128 \
        --rollout_steps 600 --bc_steps 3000 --out models/bc_init
        [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Tuple

import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import Assets, load_assets, resolve_device
from torchdriveenv_tpu_torch.models.policies import unscale_action
from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
from torchdriveenv_tpu_torch.rl.rollout import init_stack, update_stack
from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

BC_LOG_STD = -1.6       # exp(-1.6) ~ 0.2: tight but not collapsed
TARGET_CLIP = 0.98


@torch.no_grad()
def collect_demo_pairs(cfg: EnvConfig, assets: Assets, envs: int,
                       rollout_steps: int, generator: torch.Generator
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rollout_steps`` lockstep steps of ``envs`` envs driven by the
    scripted driver -> (stacks (N, 3 * frame_stack, res, res) uint8,
    actions (N, 2) f32 in (-1, 1)), N = rollout_steps * envs, step-major.
    Each pair is the frame stack the driver acted on and its action
    unscaled from the env box; both stay on the assets' device."""
    reset_fn, step_fn = make_env_fns(cfg, assets, render=True)
    drive = make_scripted_driver(cfg, assets)
    state, obs = reset_fn(generator, envs)
    stack = init_stack(obs, cfg.frame_stack)
    stacks = torch.empty((rollout_steps,) + tuple(stack.shape),
                         dtype=torch.uint8, device=stack.device)
    acts = torch.empty((rollout_steps, envs, 2), device=stack.device)
    for t in range(rollout_steps):
        a = drive(state)
        out = step_fn(state, a, generator)
        stacks[t] = stack
        acts[t] = unscale_action(a)
        stack = update_stack(stack, out.obs, out.terminated | out.truncated)
        state = out.state
    return stacks.flatten(0, 1), acts.flatten(0, 1)


def bc_loss(actor, obs: torch.Tensor, a: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (loss, action MSE). The targets are clipped inside the open
    interval: the scripted driver saturates accel at exactly +-1, and
    mse(tanh(mu), +-1) drives mu to infinity."""
    mu, log_std = actor(obs)
    a = torch.clamp(a, -TARGET_CLIP, TARGET_CLIP)
    act_mse = ((torch.tanh(mu) - a) ** 2).mean()
    std_pull = ((log_std - BC_LOG_STD) ** 2).mean()
    return act_mse + 0.05 * std_pull, act_mse


def bc_phase(actor, stacks: torch.Tensor, acts: torch.Tensor, steps: int,
             batch: int, lr: float, generator: torch.Generator
             ) -> torch.Tensor:
    """``steps`` Adam steps (a fresh Adam at ``lr``) of ``actor`` on the
    pairs, in place, each on a minibatch drawn on the device -> the action
    MSE of every step, (steps,) on the device: nothing is read to the
    host."""
    opt = torch.optim.Adam(actor.parameters(), lr=lr)
    mses = []
    for _ in range(steps):
        idx = torch.randint(0, stacks.shape[0], (batch,), generator=generator,
                            device=stacks.device)
        loss, mse = bc_loss(actor, stacks[idx], acts[idx])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        mses.append(mse.detach())
    return torch.stack(mses)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--envs", type=int, default=64)
    ap.add_argument("--rollout_steps", type=int, default=600)
    ap.add_argument("--bc_steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--init_alpha", type=float, default=0.05)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="models/bc_init")
    ap.add_argument("--device", default=None,
                    help="default: the GPU (an error without one)")
    args = ap.parse_args(argv)
    set_f32_precision()

    device = resolve_device(args.device)
    cfg = EnvConfig()
    assets = load_assets("train", device=device)
    print(f"collecting {args.rollout_steps * args.envs} demo pairs...",
          file=sys.stderr, flush=True)
    stacks, acts = collect_demo_pairs(
        cfg, assets, args.envs, args.rollout_steps,
        torch.Generator(device=device).manual_seed(args.seed))

    agent = SAC(SACConfig(init_alpha=args.init_alpha),
                obs_channels=3 * cfg.frame_stack)
    agent.init(seed=args.seed + 1, obs_res=cfg.simulator.renderer.obs_res,
               device=device)
    mses = bc_phase(agent.state.actor, stacks, acts, args.bc_steps,
                    args.batch, args.lr,
                    torch.Generator(device=device).manual_seed(args.seed + 2))
    mses = mses.cpu()
    print(f"BC {args.bc_steps} steps: action-MSE {float(mses[0]):.4f} -> "
          f"{float(mses[-100:].mean()):.4f}", file=sys.stderr, flush=True)

    # bc_phase ran its own Adam: the agent's, the actor's included, are as
    # ``init`` made them, fresh as the JAX tool's actor_opt
    tree = agent.export_state()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(tree, args.out)
    print(f"-> {args.out}", file=sys.stderr)
    return dict(path=args.out, mses=mses, pairs=stacks.shape[0])


if __name__ == "__main__":
    main()
