"""The benchmark's reference: the recurrent GRU NPC policy.

A frozen copy of the port's ``npc/policy_net.py`` (plain torch), which
later changes to the port do not reach.

A small GRU over per-agent local features drives every NPC when
``EnvConfig.npc_mode == "policy"``; its hidden state rides in
``EnvState.npc_hidden`` (B, A, HIDDEN). The weights are read from the
shipped ``torchdriveenv_tpu_torch/assets/npc_gru_v1.npz``, a raw file the
port reads too.

Feature vector per agent:
  [speed/10, target_speed/10, sin/cos heading_err, edge_grad,
   leader_gap/60, leader_dv/10, light_gap/30, present]
"""

from __future__ import annotations

import math
import os
from typing import Tuple

import numpy as np
import torch
from torch import nn

from .arrays import (
    MapArrays,
    exact_div,
    resolve_device,
    sample_npc_field,
)
from . import route_follow as rf

HIDDEN = 16
N_FEATURES = 9
ACCEL_SCALE = 4.0
STEER_SCALE = rf.STEER_BOUND

NPC_POLICY = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "torchdriveenv_tpu_torch", "assets", "npc_gru_v1.npz")


class FlaxGRUCell(nn.Module):
    """Flax's ``GRUCell`` written out, under its layer names: the input-side
    layers ``ir``, ``iz``, ``in`` have biases, the hidden-side ``hr`` and
    ``hz`` have none, ``hn`` has one. (``nn.GRUCell`` has hidden-side biases
    on all three gates: weights trained here could not go back.)

        r = sigmoid(ir(x) + hr(h)),  z = sigmoid(iz(x) + hz(h))
        n = tanh(in(x) + r * hn(h)), h' = (1 - z) * n + z * h
    """

    def __init__(self, features: int = N_FEATURES, hidden: int = HIDDEN):
        super().__init__()
        for name in ("ir", "iz", "in"):
            self.add_module(name, nn.Linear(features, hidden))
        self.hr = nn.Linear(hidden, hidden, bias=False)
        self.hz = nn.Linear(hidden, hidden, bias=False)
        self.hn = nn.Linear(hidden, hidden)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(getattr(self, "in")(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


class NpcGRU(nn.Module):
    """GRU + tanh head -> (accel, steer), over any leading axes."""

    def __init__(self, hidden: int = HIDDEN):
        super().__init__()
        self.GRUCell_0 = FlaxGRUCell(N_FEATURES, hidden)
        self.Dense_0 = nn.Linear(hidden, hidden)
        self.Dense_1 = nn.Linear(hidden, 2)

    def forward(self, h: torch.Tensor, feats: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.GRUCell_0(h, feats)
        out = self.Dense_1(torch.tanh(self.Dense_0(h)))
        act = torch.stack([ACCEL_SCALE * torch.tanh(out[..., 0]),
                           STEER_SCALE * torch.tanh(out[..., 1])], dim=-1)
        return h, act


def load_npc_policy(path: str, device) -> NpcGRU:
    """The policy stored in an exported ``.npz`` on ``device``, frozen."""
    with np.load(path) as z:
        state = {k: torch.from_numpy(z[k]) for k in z.files}
    policy = NpcGRU()
    policy.load_state_dict(state)
    return policy.to(device).requires_grad_(False).eval()


def _features(maps: MapArrays, town: torch.Tensor, t: torch.Tensor,
              states: torch.Tensor, attrs: torch.Tensor, present: torch.Tensor,
              target_speed: torch.Tensor) -> torch.Tensor:
    """Per-agent local features (B, A, N_FEATURES): one packed-field gather,
    the route follower's leader and stopline gaps."""
    px, py, psi, v = (states[..., 0], states[..., 1], states[..., 2],
                      states[..., 3])
    fx, fy = torch.cos(psi), torch.sin(psi)
    lx, ly = -torch.sin(psi), torch.cos(psi)
    lookahead = torch.clamp(v * 0.6, min=3.0)
    # left-offset probe = right-lane keeping, as the JAX code has it
    probe = torch.stack([px + fx * lookahead + lx * rf.LANE_OFFSET,
                         py + fy * lookahead + ly * rf.LANE_OFFSET], dim=-1)
    dir_tgt, gx, gy = sample_npc_field(maps, town, probe)
    # the field is a line field: fold the heading error into (-pi/2, pi/2]
    herr = rf._wrap(dir_tgt - psi)
    herr = torch.where(torch.abs(herr) > math.pi / 2, rf._wrap(herr + math.pi),
                       herr)
    edge = gx * lx + gy * ly

    leader_gap, leader_v = rf.leader_gaps(states, attrs, present)
    light_gap = rf.light_gaps(maps, town, t, states, attrs)
    lg = torch.clamp(torch.where(torch.isfinite(leader_gap), leader_gap,
                                 torch.full_like(leader_gap, 60.0)), 0.0, 60.0)
    dv = torch.clamp(v - leader_v, -10.0, 10.0)
    sg = torch.clamp(torch.where(torch.isfinite(light_gap), light_gap,
                                 torch.full_like(light_gap, 30.0)), 0.0, 30.0)
    return torch.stack([
        exact_div(v, 10.0), exact_div(target_speed, 10.0), torch.sin(herr),
        torch.cos(herr), torch.clamp(edge, -1.5, 1.5), exact_div(lg, 60.0),
        exact_div(dv, 10.0), exact_div(sg, 30.0),
        present.to(torch.float32)], dim=-1)


def init_hidden(num_envs: int, n_agents: int, device=None) -> torch.Tensor:
    """Fresh recurrent state (B, A, HIDDEN): zeros, the analogue of the
    reference's fresh-agent recurrent state (gym_env.py:198)."""
    return torch.zeros((num_envs, n_agents, HIDDEN),
                       device=resolve_device(device))


def policy_actions(policy: NpcGRU, feats: torch.Tensor, hidden: torch.Tensor,
                   states: torch.Tensor, target_speed: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GRU on given features, then the rules it may not break: parked
    agents brake to a stop and go straight, nobody reverses. -> (actions
    (B, A, 2), next hidden (B, A, HIDDEN))."""
    h, act = policy(hidden, feats)
    v = states[..., 3]
    parked = target_speed < 0.1
    hold = torch.stack([torch.clamp(-4.0 * v, *rf.ACCEL_BOUNDS),
                        torch.zeros_like(v)], dim=-1)
    act = torch.where(parked[..., None], hold, act)
    act = torch.stack([torch.maximum(act[..., 0], exact_div(-v, 0.1)),
                       act[..., 1]],
                      dim=-1)
    return act, h


def npc_policy_actions(policy: NpcGRU, maps: MapArrays, town: torch.Tensor,
                       t: torch.Tensor, states: torch.Tensor,
                       attrs: torch.Tensor, present: torch.Tensor,
                       target_speed: torch.Tensor, hidden: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, A, 2) actions + next hidden (B, A, HIDDEN) of every agent; the
    caller overrides the ego's."""
    feats = _features(maps, town, t, states, attrs, present, target_speed)
    return policy_actions(policy, feats, hidden, states, target_speed)
