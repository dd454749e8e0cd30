"""The comparison that decides ``correct`` for the env step: the program's
outputs against the reference's, from the same state, actions and
generator state.

An env is *flipped* where any of its discrete outputs parts from the
reference's: town, case, the present mask, the step, target and reached
counters, the terminated and truncated flags, the infraction flags
(offroad, collision, light violation > 0), ``is_success`` and the reached
count. A flip moves the whole env (a reset, another NPC's decision), so
the float and pixel readings are taken over the envs that did not flip:

- ``flipped_envs``: the share of envs flipped;
- ``float_gap``: the largest gap of a float output (the state's floats, the
  GRU state, the reward and the float infos), in units of the golden
  tolerance ``atol + rtol * |reference|`` (atol 1e-4, rtol 1e-5, the
  tolerance the port is held to against the JAX package);
- ``pixels_off``: the share of frame values (uint8) that differ.
"""

from __future__ import annotations

from typing import Dict

import torch

ATOL, RTOL = 1e-4, 1e-5
DISCRETE_STATE = ("town", "case", "present", "step_idx", "target_idx",
                  "reached_num")
FLOAT_STATE = ("agent_states", "agent_attrs", "npc_target_speed", "time0",
               "npc_hidden")
FLAG_INFOS = ("offroad", "collision", "traffic_light_violation")
DISCRETE_INFOS = ("is_success", "reached_waypoint_num")
FLOAT_INFOS = ("offroad", "collision", "traffic_light_violation",
               "psi_smoothness", "psi_reward", "dist_reward",
               "speed_smoothness")


def _per_env(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _differs(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return (_per_env(p) != _per_env(r)).any(dim=1)


def _gap(p: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per env, the largest |p - r| / (ATOL + RTOL |r|); inf where one side
    is NaN and the other is not, 0 where both are NaN or equal infs."""
    p, r = _per_env(p.float()), _per_env(r.float())
    same = (p == r) | (torch.isnan(p) & torch.isnan(r))
    g = (p - r).abs() / (ATOL + RTOL * r.abs())
    g = torch.where(same, torch.zeros_like(g), g)
    g = torch.nan_to_num(g, nan=float("inf"))
    return g.amax(dim=1) if g.shape[1] else torch.zeros(p.shape[0],
                                                         device=p.device)


class Tally:
    """Readings summed over every compared answer."""

    def __init__(self):
        self.envs = self.flipped = 0
        self.values = self.values_off = 0
        self.float_gap = 0.0

    def add(self, flipped: torch.Tensor, gap: torch.Tensor,
            frames_p, frames_r) -> None:
        keep = ~flipped
        self.envs += int(flipped.numel())
        self.flipped += int(flipped.sum())
        if bool(keep.any()):
            self.float_gap = max(self.float_gap, float(gap[keep].max()))
        for fp, fr in zip(frames_p, frames_r):
            self.values += int(fp[keep].numel())
            self.values_off += int((fp[keep] != fr[keep]).sum())

    def readings(self) -> Dict[str, float]:
        return {
            "flipped_envs": self.flipped / max(self.envs, 1),
            "float_gap": self.float_gap,
            "pixels_off": self.values_off / max(self.values, 1),
        }


def _state_parts(p, r):
    flipped = torch.zeros(p.town.shape[0], dtype=torch.bool,
                          device=p.town.device)
    gap = torch.zeros(p.town.shape[0], device=p.town.device)
    for k in DISCRETE_STATE:
        flipped |= _differs(getattr(p, k), getattr(r, k))
    for k in FLOAT_STATE:
        a, b = getattr(p, k), getattr(r, k)
        if (a is None) != (b is None):
            flipped |= True
        elif a is not None:
            gap = torch.maximum(gap, _gap(a, b))
    return flipped, gap


def add_reset(tally: Tally, state_p, obs_p, ref: dict) -> None:
    """The first reset: the program's state and frames against the
    reference's."""
    flipped, gap = _state_parts(state_p, ref["state"])
    tally.add(flipped, gap, [obs_p], [ref["obs"]])


def add_step(tally: Tally, out_p, ref: dict) -> None:
    """One step: the program's ``StepOutput`` against the reference's."""
    flipped, gap = _state_parts(out_p.state, ref["state"])
    for k in ("terminated", "truncated"):
        flipped |= _differs(getattr(out_p, k), ref[k])
    for k in FLAG_INFOS:
        flipped |= _differs(out_p.info[k] > 0, ref["info"][k] > 0)
    for k in DISCRETE_INFOS:
        flipped |= _differs(out_p.info[k], ref["info"][k])
    gap = torch.maximum(gap, _gap(out_p.reward, ref["reward"]))
    for k in FLOAT_INFOS:
        gap = torch.maximum(gap, _gap(out_p.info[k], ref["info"][k]))
    frames_p, frames_r = [out_p.obs], [ref["obs"]]
    if out_p.final_obs is not None or "final_obs" in ref:
        frames_p.append(out_p.final_obs)
        frames_r.append(ref["final_obs"])
    tally.add(flipped, gap, frames_p, frames_r)
