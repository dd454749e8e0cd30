"""The reference's env configuration: the fields of the port's
``EnvConfig`` that the env step reads, with the port's defaults, built from
a benchmark configuration's ``env`` group and a traffic mix's overrides."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field, fields


@dataclass
class RendererConfig:
    left_handed_coordinates: bool = True
    highlight_ego_vehicle: bool = True
    obs_res: int = 64
    obs_fov: float = 70.0


class CollisionMetric(str, enum.Enum):
    nograd = "nograd"
    discs = "discs"


@dataclass
class TorchDriveConfig:
    renderer: RendererConfig = field(default_factory=RendererConfig)
    collision_metric: CollisionMetric = CollisionMetric.nograd
    max_agents: int = 96
    dt: float = 0.1
    bicycle_beta_factor: float = 0.5


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
    simulator: TorchDriveConfig = field(default_factory=TorchDriveConfig)
    npc_mode: str = "route"
    reset_pool: int = 256


def env_config(raw: dict) -> EnvConfig:
    """A nested dict (the configuration file's ``env`` group) -> EnvConfig.
    An unknown key raises ``KeyError``."""
    def build(cls, d):
        known = {f.name: f for f in fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in known:
                raise KeyError(f"unknown {cls.__name__} key {k!r}")
            if isinstance(v, dict):
                v = build({"simulator": TorchDriveConfig,
                           "renderer": RendererConfig}[k], v)
            elif k == "collision_metric":
                v = CollisionMetric(v)
            kwargs[k] = v
        return cls(**kwargs)
    return build(EnvConfig, raw)
