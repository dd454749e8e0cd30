"""Environment configuration: the port's own copy of the JAX package's
``RendererConfig``, ``CollisionMetric``, ``TorchDriveConfig`` and
``EnvConfig`` (field for field).

``RendererConfig.backend`` names this package's rasterizer routes:
``"cuda"`` (the hand-written kernel), ``"torch"`` (its plain twin) or
``"auto"`` (the kernel for tensors on a CUDA device, the twin on the CPU).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class RendererConfig:
    left_handed_coordinates: bool = True
    highlight_ego_vehicle: bool = True
    obs_res: int = 64          # observation resolution (3 x 64 x 64)
    obs_fov: float = 70.0      # meters visible across the observation window
    render_waypoints: bool = True
    render_traffic_lights: bool = True
    backend: str = "auto"      # "cuda" (kernel) | "torch" (twin) | "auto"


class CollisionMetric(str, enum.Enum):
    nograd = "nograd"
    discs = "discs"


@dataclass
class TorchDriveConfig:
    renderer: RendererConfig = field(default_factory=RendererConfig)
    collision_metric: CollisionMetric = CollisionMetric.nograd
    left_handed_coordinates: bool = True
    max_agents: int = 96       # padded agent capacity
    dt: float = 0.1            # 10 fps
    bicycle_beta_factor: float = 0.5   # slip ratio lr / (lf + lr)


@dataclass
class EnvConfig:
    ego_only: bool = False
    max_environment_steps: int = 200
    frame_stack: int = 3
    waypoint_bonus: float = 100.0
    heading_penalty: float = 25.0
    distance_bonus: float = 1.0
    distance_cutoff: float = 0.5
    use_background_traffic: bool = True
    terminated_at_infraction: bool = True
    seed: Optional[int] = None
    simulator: TorchDriveConfig = field(default_factory=TorchDriveConfig)
    render_mode: Optional[str] = "rgb_array"
    video_filename: Optional[str] = "rendered_video.mp4"
    video_res: Optional[int] = 1024
    video_fov: Optional[float] = 500.0
    device: Optional[str] = None
    # "route" = deterministic IDM route-follower (ported); "policy" = the GRU
    # NPC policy, not yet ported (env/core.py raises for it)
    npc_mode: str = "route"
    # fresh reset states sampled per batch step for the auto-reset:
    # 0 = one per env; N = a pool of N consumed rank-ordered by done envs
    reset_pool: int = 256
