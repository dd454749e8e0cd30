"""Kinematic bicycle integrator (the benchmark's reference: a frozen copy of
the port's ``ops/bicycle.py``).

    beta = atan(beta_factor * tan(steering))
    x'   = v * cos(psi + beta)
    y'   = v * sin(psi + beta)
    psi' = v * sin(beta) / lr
    v'   = a

integrated by explicit Euler at dt. State layout ``[x, y, psi, speed]``;
broadcasts over any leading batch / agent dims.
"""

from __future__ import annotations

import torch


def bicycle_step(state: torch.Tensor, action: torch.Tensor, lr: torch.Tensor,
                 dt: float = 0.1, beta_factor: float = 0.5) -> torch.Tensor:
    """state (..., 4), action (..., 2) [accel, steer], lr (...) -> (..., 4)."""
    x, y, psi, v = state[..., 0], state[..., 1], state[..., 2], state[..., 3]
    a, steer = action[..., 0], action[..., 1]
    lr = torch.clamp(lr, min=1e-3)
    beta = torch.arctan(beta_factor * torch.tan(steer))
    x = x + v * torch.cos(psi + beta) * dt
    y = y + v * torch.sin(psi + beta) * dt
    psi = psi + v * torch.sin(beta) / lr * dt
    v = v + a * dt
    return torch.stack([x, y, psi, v], dim=-1)
