"""Gymnasium single-agent adapter over the batched engine (port of
``torchdriveenv_tpu/env/gym_adapter.py``), registered as
``torchdriveenv-torch-v0``.

The engine runs one env (B = 1) on the GPU, or on the device the caller
names (``device="cpu"``); the adapter converts at the host boundary:

  action  np.float32 (2,)        -> device (1, 2)
  obs     device (1, 3, res,res) -> np.uint8 (3, res, res)
  reward/terminated/truncated/info -> python scalars / np arrays

There is no auto-reset (the Gymnasium contract: the caller calls
``reset()`` after an episode ends), so a terminal step returns the
terminal observation. Observations and the video come from the SDF-grid
renderer ``ops/rasterizer.py:render_egocentric``, the video at
``video_res`` / ``video_fov`` (1024 px over 500 m by default).

Randomness comes from a ``torch.Generator`` on the env's device, seeded
from ``set_seeds(cfg.seed)`` and re-seeded by ``reset(seed=)``; the
episodes it draws are reproducible on one device, not across devices or
against the JAX adapter's PRNG keys.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import gymnasium as gym
import numpy as np
import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.maps.arrays import Assets, load_assets, resolve_device
from torchdriveenv_tpu_torch.npc.policy_net import default_params
from torchdriveenv_tpu_torch.ops.rasterizer import render_egocentric
from torchdriveenv_tpu_torch.utils.seeding import set_seeds


class TorchGymEnv(gym.Env):
    """Single-agent Gymnasium view of the batched engine (B = 1).

    Reference counterparts: ``GymEnv``/``WaypointSuiteEnv`` +
    ``SingleAgentWrapper`` (gym_env.py:71-176,303-487).
    """

    metadata = {"render_modes": ["video", "rgb_array"], "render_fps": 10}

    def __init__(self, cfg: EnvConfig, data: Any = None,
                 assets: Optional[Assets] = None, device=None):
        """``data``: "train" / "val" or loaded ``Assets``. ``device``
        (default ``cfg.device``, and then the GPU) must be the assets'."""
        self.cfg = cfg
        dev = resolve_device(device if device is not None else cfg.device)
        if assets is None:
            if isinstance(data, Assets):
                assets = data
            else:
                assets = load_assets("train" if data is None else data,
                                     device=dev)
        if assets.device.type != dev.type:
            raise ValueError(f"assets are on {assets.device}, the env on {dev}")
        self.assets = assets
        self.device = assets.device
        # action space: accel in [-1, 1], steering in [-0.3, 0.3]
        # (reference gym_env.py:83-94)
        self.action_space = gym.spaces.Box(
            low=np.array([-1.0, -0.3], np.float32),
            high=np.array([1.0, 0.3], np.float32), shape=(2,), dtype=np.float32)
        res = cfg.simulator.renderer.obs_res
        # obs space: uint8 channel-first birdview (reference gym_env.py:95)
        self.observation_space = gym.spaces.Box(
            low=0, high=255, shape=(3, res, res), dtype=np.uint8)

        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(set_seeds(cfg.seed))
        self._state: Optional[core.EnvState] = None
        self._frames = []  # video-mode frame buffer
        self._npc_params = (default_params(self.device)
                            if cfg.npc_mode == "policy" else None)

    def _render_obs(self, state: core.EnvState, res: Optional[int] = None,
                    fov: Optional[float] = None) -> np.ndarray:
        """The (3, res, res) uint8 frame of the one env of ``state``."""
        rcfg = self.cfg.simulator.renderer
        t = state.time0 + state.step_idx.to(torch.float32) * self.cfg.simulator.dt
        case = state.case.long()
        frame = render_egocentric(
            self.assets.maps, state.town, t,
            state.agent_states, state.agent_attrs, state.present,
            self.assets.suite.waypoints[case], state.target_idx,
            self.assets.suite.n_waypoints[case],
            res=res or rcfg.obs_res, fov=fov or rcfg.obs_fov,
            left_handed=rcfg.left_handed_coordinates,
            highlight_ego=rcfg.highlight_ego_vehicle)
        return frame[0].cpu().numpy()

    # -- gym API ------------------------------------------------------------

    def _get_obs(self) -> np.ndarray:
        obs = self._render_obs(self._state)
        if self.cfg.render_mode == "video":
            self._frames.append(self._render_obs(
                self._state, res=int(self.cfg.video_res or 1024),
                fov=float(self.cfg.video_fov or 500.0)))
        return obs

    def reset(self, *, seed: Optional[int] = None, options=None
              ) -> Tuple[np.ndarray, Dict]:
        super().reset(seed=seed)
        if seed is not None:
            self._generator.manual_seed(seed)
        self._state = core.reset(self.cfg, self.assets, 1, self._generator)
        return self._get_obs(), {}

    def step(self, action) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        action = torch.as_tensor(np.asarray(action, np.float32).reshape(1, 2),
                                 device=self.device)
        self._state, reward, term, trunc, info = core.step(
            self.cfg, self.assets, self._state, action,
            npc_params=self._npc_params)
        obs = self._get_obs()
        # the reference exposes the per-term reward breakdown in info
        # (gym_env.py:419-437)
        info = {k: v[0].cpu().numpy() for k, v in info.items()}
        return obs, float(reward[0]), bool(term[0]), bool(trunc[0]), info

    def mock_step(self, action=None
                  ) -> Tuple[np.ndarray, float, bool, bool, Dict]:
        """Canned transition without advancing the simulator: the built-in
        fake the reference keeps for simulator / API failures (reference
        gym_env.py:159-170)."""
        obs = (self._render_obs(self._state) if self._state is not None
               else np.zeros(self.observation_space.shape, np.uint8))
        info = {"offroad": np.zeros(()), "collision": np.zeros(()),
                "traffic_light_violation": np.zeros(()),
                "is_success": np.asarray(False)}
        return obs, 0.0, False, True, info

    def render(self) -> Optional[np.ndarray]:
        # rgb_array mode: an HWC uint8 frame (reference gym_env.py:152-157)
        return self._render_obs(self._state).transpose(1, 2, 0)

    def close(self):
        if self.cfg.render_mode == "video" and self._frames:
            from torchdriveenv_tpu_torch.utils.video import save_video
            save_video([f.transpose(1, 2, 0) for f in self._frames],
                       self.cfg.video_filename or "rendered_video.mp4",
                       fps=self.metadata["render_fps"])
            self._frames = []


def make_gym_env(cfg: Optional[EnvConfig] = None, data: Any = None,
                 **kwargs) -> gym.Env:
    """Entry point for ``gym.make('torchdriveenv-torch-v0', args={...})``:
    ``args`` holds ``cfg``, ``data`` ("train" / "val" or ``Assets``) and
    optionally ``assets`` and ``device`` (reference entry lambda,
    torchdriveenv/__init__.py:10)."""
    return TorchGymEnv(cfg or EnvConfig(), data=data, **kwargs)
