"""Evaluation harness: the reference's 9-metric benchmark suite (port of
``torchdriveenv_tpu/rl/evaluate.py``).

  mean_episode_reward, mean_episode_length, offroad_rate, collision_rate,
  traffic_light_violation_rate, success_percentage, reached_waypoint_num
  (mean over episodes), psi_smoothness, speed_smoothness (per-episode means).

One episode per env, run in lockstep to the step horizon; per-env
accumulators freeze at that env's first episode end ("n episodes" is the
env batch size).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from torchdriveenv_tpu_torch.rl.rollout import init_stack, update_stack


def make_evaluator(reset_fn, step_fn, policy: Callable, frame_stack: int,
                   scale_action: Callable, max_steps: int = 200, cases=None,
                   n_cases: Optional[int] = None):
    """policy(policy_state, obs_stack) -> normalized deterministic action
    (E, A); ``policy_state`` is handed through ``evaluate`` unchanged.

    reset_fn(generator, num_envs, cases) -> (state, obs) and
    step_fn(state, action, generator) -> StepOutput, as
    ``env.batched.make_env_fns`` returns them.

    ``cases``: optional per-episode fixed scenario indices (one per episode)
    with ``n_cases`` the suite size. When given, episodes start on those
    cases and the metric dict also carries ``success_case_{i}`` /
    ``reached_case_{i}`` per case.

    Returns evaluate(generator, num_envs, policy_state) -> metric dict of
    0-d tensors.
    """

    @torch.no_grad()
    def evaluate(generator: torch.Generator, num_envs: int,
                 policy_state=None) -> Dict[str, torch.Tensor]:
        case_t = None
        if cases is not None:
            case_t = torch.as_tensor(cases, device=generator.device).to(
                torch.int32)
        env_state, obs = reset_fn(generator, num_envs, case_t)
        e, dev = obs.shape[0], obs.device
        stack = init_stack(obs, frame_stack)

        alive = torch.ones(e, dtype=torch.bool, device=dev)
        reward = torch.zeros(e, device=dev)
        length = torch.zeros(e, dtype=torch.int32, device=dev)
        offroad, collision, light, success = (
            torch.zeros(e, dtype=torch.bool, device=dev) for _ in range(4))
        reached = torch.zeros(e, dtype=torch.int32, device=dev)
        psi_sm_sum = torch.zeros(e, device=dev)
        speed_sm_sum = torch.zeros(e, device=dev)

        for _ in range(max_steps):
            a = policy(policy_state, stack)
            out = step_fn(env_state, scale_action(a), generator)
            done = out.terminated | out.truncated
            info = out.info
            reward = reward + torch.where(alive, out.reward, 0.0)
            length = length + alive.to(torch.int32)
            offroad = offroad | (alive & (info["offroad"] > 0))
            collision = collision | (alive & (info["collision"] > 0))
            light = light | (alive & (info["traffic_light_violation"] > 0))
            success = success | (alive & info["is_success"])
            reached = torch.where(alive, info["reached_waypoint_num"], reached)
            psi_sm_sum = psi_sm_sum + torch.where(
                alive, info["psi_smoothness"], 0.0)
            speed_sm_sum = speed_sm_sum + torch.where(
                alive, info["speed_smoothness"], 0.0)
            alive = alive & ~done
            stack = update_stack(stack, out.obs, done)
            env_state = out.state

        f32 = torch.float32
        length_f = torch.clamp(length.to(f32), min=1.0)
        metrics = dict(
            mean_episode_reward=reward.mean(),
            mean_episode_length=length_f.mean(),
            offroad_rate=offroad.to(f32).mean(),
            collision_rate=collision.to(f32).mean(),
            traffic_light_violation_rate=light.to(f32).mean(),
            success_percentage=success.to(f32).mean(),
            reached_waypoint_num=reached.to(f32).mean(),
            psi_smoothness=(psi_sm_sum / length_f).mean(),
            speed_smoothness=(speed_sm_sum / length_f).mean(),
        )
        if case_t is not None:
            onehot = torch.nn.functional.one_hot(case_t.long(), n_cases).to(f32)
            n_per = torch.clamp(onehot.sum(0), min=1.0)       # episodes / case
            succ = (onehot * success[:, None].to(f32)).sum(0) / n_per
            reach = (onehot * reached[:, None].to(f32)).sum(0) / n_per
            for i in range(n_cases):
                metrics[f"success_case_{i}"] = succ[i]
                metrics[f"reached_case_{i}"] = reach[i]
        return metrics

    return evaluate
