"""Configuration tree: the port's own copy of the JAX package's
``RendererConfig``, ``CollisionMetric``, ``TorchDriveConfig``, ``EnvConfig``
and the training configs (``RlTrainingConfig`` and its callbacks), field for
field, with the loaders that build them from the repo's YAML files.

PyYAML is imported only where a file is opened (``load_env_config``,
``load_rl_training_config``); a parsed dict becomes a config through
``construct_env_config`` / ``construct_rl_training_config`` without it.

``RendererConfig.backend`` names this package's rasterizer routes:
``"cuda"`` (the hand-written kernel), ``"torch"`` (its plain twin) or
``"auto"`` (the kernel for tensors on a CUDA device, the twin on the CPU).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


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
    # "route" = deterministic IDM route-follower; "policy" = the recurrent
    # GRU NPC policy (npc/policy_net.py)
    npc_mode: str = "route"
    # fresh reset states sampled per batch step for the auto-reset:
    # 0 = one per env; N = a pool of N consumed rank-ordered by done envs
    reset_pool: int = 256


class BaselineAlgorithm(str, enum.Enum):
    sac = "sac"
    ppo = "ppo"
    a2c = "a2c"
    td3 = "td3"


@dataclass
class RlCallbackConfig:
    n_steps: int = 1000
    eval_n_episodes: int = 10
    deterministic: bool = True
    record: bool = True


@dataclass
class WandbCallbackConfig:
    verbose: bool = True
    gradient_save_freq: int = 100
    model_save_freq: int = 100


@dataclass
class RlTrainingConfig:
    algorithm: Optional[BaselineAlgorithm] = None
    parallel_env_num: int = 2
    project: str = "torchdriveenv_tpu"
    total_timesteps: float = 5e6
    record_training_examples: bool = True
    env: EnvConfig = field(default_factory=EnvConfig)
    eval_train_callback: RlCallbackConfig = field(default_factory=RlCallbackConfig)
    eval_val_callback: RlCallbackConfig = field(default_factory=RlCallbackConfig)
    wandb_callback: WandbCallbackConfig = field(default_factory=WandbCallbackConfig)
    checkpoint_dir: Optional[str] = None
    log_dir: str = "runs"
    # overrides for the algorithm's config dataclass (PPOConfig / SACConfig
    # / ...), e.g. {n_steps: 32, batch_size: 8192} to scale PPO to 1024 envs
    algo_kwargs: Optional[dict] = None
    # off-policy (SAC / TD3) iteration shape: lockstep env steps, then
    # gradient updates, per train step
    offpolicy_steps_per_iter: int = 8
    offpolicy_updates_per_iter: int = 8
    # off-policy demonstration warmup: for the first N env steps actions
    # come from the scripted driver (rl/demo.py) instead of the policy.
    # 0 = off (SB3's random warmup)
    demo_warmup_steps: int = 0
    # keep the first K envs scripted for the whole run
    demo_envs: int = 0
    # full-carry snapshot cadence (agent, optimizers, replay buffer, env
    # states, generator) in env steps. > 0: periodic snapshots plus one at
    # the end of the run; 0 (default): the end-of-run `full_latest` only, so
    # --resume_from always has something to restore; < 0: none at all
    # (model-only saves still happen at model_save_freq). A full SAC carry
    # holds the replay frames: gigabytes.
    full_snapshot_every: int = 0


def _build_dataclass(cls, raw: Any):
    """Recursively build a dataclass from nested dicts (parsed YAML)."""
    if raw is None:
        return cls()
    if dataclasses.is_dataclass(raw):
        return raw
    if not isinstance(raw, dict):
        return raw
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in raw.items():
        if key not in names:
            raise TypeError(f"Unknown config field {key!r} for {cls.__name__}")
        target = _FIELD_TYPES.get((cls.__name__, key))
        if target is not None and isinstance(value, dict):
            kwargs[key] = _build_dataclass(target, value)
        elif (target is not None and issubclass(target, enum.Enum)
              and value is not None):
            kwargs[key] = target(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


_FIELD_TYPES = {
    ("TorchDriveConfig", "renderer"): RendererConfig,
    ("TorchDriveConfig", "collision_metric"): CollisionMetric,
    ("EnvConfig", "simulator"): TorchDriveConfig,
    ("RlTrainingConfig", "env"): EnvConfig,
    ("RlTrainingConfig", "eval_train_callback"): RlCallbackConfig,
    ("RlTrainingConfig", "eval_val_callback"): RlCallbackConfig,
    ("RlTrainingConfig", "wandb_callback"): WandbCallbackConfig,
    ("RlTrainingConfig", "algorithm"): BaselineAlgorithm,
}


def construct_env_config(raw_config: Optional[Dict[str, Any]]) -> EnvConfig:
    """A parsed dict -> ``EnvConfig``; unknown fields raise ``TypeError``."""
    return _build_dataclass(EnvConfig, raw_config)


def construct_rl_training_config(raw_config: Optional[Dict[str, Any]]
                                 ) -> RlTrainingConfig:
    """A parsed dict -> ``RlTrainingConfig``: the algorithm as its enum and
    ``total_timesteps`` (which YAML may spell ``5e7``) as an int."""
    cfg = _build_dataclass(RlTrainingConfig, raw_config)
    if cfg.algorithm is not None and not isinstance(cfg.algorithm,
                                                    BaselineAlgorithm):
        cfg.algorithm = BaselineAlgorithm(cfg.algorithm)
    cfg.total_timesteps = int(float(cfg.total_timesteps))
    return cfg


def _load_yaml(yaml_path: str):
    import yaml
    with open(yaml_path) as f:
        return yaml.safe_load(f)


def load_env_config(yaml_path: str) -> EnvConfig:
    return construct_env_config(_load_yaml(yaml_path))


def load_rl_training_config(yaml_path: str) -> RlTrainingConfig:
    return construct_rl_training_config(_load_yaml(yaml_path))
