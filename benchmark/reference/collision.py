"""Oriented-bounding-box collision (the benchmark's reference: a frozen copy of
the port's ``ops/collision.py``): the separating-axis (SAT)
penetration depth, 0 when disjoint, and the disc approximation.

The JAX functions take one env's agents ``(A, ...)``; these take any leading
batch dims ``(..., A, ...)``.
"""

from __future__ import annotations

import torch


def obb_corners(states: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """states (..., 4) [x, y, psi, v], sizes (..., 2) [length, width]
    -> corners (..., 4, 2)."""
    x, y, psi = states[..., 0], states[..., 1], states[..., 2]
    hl, hw = sizes[..., 0] / 2.0, sizes[..., 1] / 2.0
    c, s = torch.cos(psi), torch.sin(psi)
    lx = torch.stack([hl, hl, -hl, -hl], dim=-1)
    ly = torch.stack([hw, -hw, -hw, hw], dim=-1)
    cx = x[..., None] + lx * c[..., None] - ly * s[..., None]
    cy = y[..., None] + lx * s[..., None] + ly * c[..., None]
    return torch.stack([cx, cy], dim=-1)


def _sat_penetration(state_a, size_a, state_b, size_b):
    """SAT penetration depth between OBBs, broadcast over leading dims.
    Tests the 4 candidate axes (2 per box); >= 0, and 0 iff separated."""
    dx = state_b[..., 0] - state_a[..., 0]
    dy = state_b[..., 1] - state_a[..., 1]
    ca, sa = torch.cos(state_a[..., 2]), torch.sin(state_a[..., 2])
    cb, sb = torch.cos(state_b[..., 2]), torch.sin(state_b[..., 2])
    # each box's axes: rows (c, s) and (-s, c)
    axes = [(ca, sa), (-sa, ca), (cb, sb), (-sb, cb)]

    def half_extent(ux, uy, c, s, size):
        hl, hw = size[..., 0] / 2.0, size[..., 1] / 2.0
        return (hl * torch.abs(c * ux + s * uy)
                + hw * torch.abs(-s * ux + c * uy))

    overlaps = []
    for ux, uy in axes:
        ra = half_extent(ux, uy, ca, sa, size_a)
        rb = half_extent(ux, uy, cb, sb, size_b)
        dist = torch.abs(dx * ux + dy * uy)
        overlaps.append(ra + rb - dist)
    pen = torch.stack(overlaps, dim=-1)
    return torch.clamp(pen.amin(dim=-1), min=0.0)


def pairwise_collision(states: torch.Tensor, sizes: torch.Tensor,
                       present: torch.Tensor) -> torch.Tensor:
    """states (..., A, 4), sizes (..., A, 2), present (..., A) -> (..., A, A)
    penetration depths, zero on the diagonal and for absent pairs."""
    a = states.shape[-2]
    pen = _sat_penetration(states[..., :, None, :], sizes[..., :, None, :],
                           states[..., None, :, :], sizes[..., None, :, :])
    eye = torch.eye(a, dtype=torch.bool, device=states.device)
    mask = present[..., :, None] & present[..., None, :] & ~eye
    return torch.where(mask, pen, torch.zeros_like(pen))


def _others_mask(present: torch.Tensor, ego_index: int) -> torch.Tensor:
    a = present.shape[-1]
    not_ego = torch.arange(a, device=present.device) != ego_index
    return present & not_ego & present[..., ego_index:ego_index + 1]


def ego_collision(states: torch.Tensor, sizes: torch.Tensor,
                  present: torch.Tensor, ego_index: int = 0) -> torch.Tensor:
    """Max penetration of the ego box against all other present agents.
    states (..., A, 4) -> (...)."""
    pen = _sat_penetration(states[..., ego_index:ego_index + 1, :],
                           sizes[..., ego_index:ego_index + 1, :],
                           states, sizes)
    mask = _others_mask(present, ego_index)
    return torch.where(mask, pen, torch.zeros_like(pen)).amax(dim=-1)


N_DISCS = 5


def _disc_centers(states: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """N_DISCS circles of radius width/2 along the body axis.
    states (..., 4), sizes (..., 2) -> centers (..., N_DISCS, 2)."""
    x, y, psi = states[..., 0], states[..., 1], states[..., 2]
    hl, hw = sizes[..., 0] / 2.0, sizes[..., 1] / 2.0
    span = torch.clamp(hl - hw, min=0.0)
    t = torch.linspace(-1.0, 1.0, N_DISCS, device=states.device)
    off = span[..., None] * t
    cx = x[..., None] + off * torch.cos(psi)[..., None]
    cy = y[..., None] + off * torch.sin(psi)[..., None]
    return torch.stack([cx, cy], dim=-1)


def ego_collision_discs(states: torch.Tensor, sizes: torch.Tensor,
                        present: torch.Tensor, ego_index: int = 0
                        ) -> torch.Tensor:
    """Disc-approximation penetration of the ego against all present agents
    (``CollisionMetric.discs``). states (..., A, 4) -> (...)."""
    ego_c = _disc_centers(states[..., ego_index, :], sizes[..., ego_index, :])
    ego_r = sizes[..., ego_index, 1] / 2.0                         # (...)
    all_c = _disc_centers(states, sizes)                          # (..., A, N, 2)
    all_r = sizes[..., 1] / 2.0                                   # (..., A)
    diff = ego_c[..., None, :, None, :] - all_c[..., :, None, :, :]
    d = torch.sqrt((diff * diff).sum(dim=-1))                     # (..., A, N, N)
    pen = torch.clamp(ego_r[..., None, None, None] + all_r[..., None, None] - d,
                      min=0.0)
    mask = _others_mask(present, ego_index)[..., None, None]
    return torch.where(mask, pen, torch.zeros_like(pen)).flatten(-3).amax(dim=-1)
