"""torchdriveenv_tpu_torch — the PyTorch / CUDA port of ``torchdriveenv_tpu``.

The batched driving environment (bicycle kinematics, IDM route-follower
NPCs, OBB collision, SDF offroad, traffic lights, waypoint reward, pooled
auto-reset and the 3x64x64 birdview) in plain PyTorch, with the birdview
rasterizer as a hand-written CUDA kernel (``csrc/rasterizer.cu``); and the
learners on top of it (``models``, ``rl``, ``parallel``): NatureCNN
policies, SAC, TD3, PPO and A2C, the frame-stacked replay buffer, the fused
off-policy and on-policy train steps, the scripted demonstration policy, the
evaluator and the training CLI (``python -m torchdriveenv_tpu_torch.rl.train``);
the GRU NPC policy (``npc/policy_net.py``, ``EnvConfig(npc_mode="policy")``);
and the Gymnasium adapter over the SDF-grid renderer, registered as
``torchdriveenv-torch-v0`` when gymnasium imports (``torchdriveenv-v0`` is
the JAX package's).

The JAX package stays the reference. This package imports nothing of it:
it reads the same compiled asset files by path.
"""

__version__ = "0.1.0"

import os

# The JAX package's compiled assets, read in place (never copied).
_pkg_dir = os.path.dirname(os.path.realpath(__file__))
_data_path = [os.path.normpath(os.path.join(_pkg_dir, "..", "torchdriveenv_tpu",
                                            "assets"))]


def _register_gym():
    """Register ``torchdriveenv-torch-v0`` if gymnasium is importable:
    ``gym.make("torchdriveenv-torch-v0", args={"cfg": ..., "data": ...,
    "device": ...})`` builds ``env.gym_adapter.TorchGymEnv``."""
    try:
        import gymnasium as gym
    except ImportError:
        return

    def _entry(args=None):
        from torchdriveenv_tpu_torch.env.gym_adapter import make_gym_env

        return make_gym_env(**(args or {}))

    if "torchdriveenv-torch-v0" not in gym.registry:
        gym.register(id="torchdriveenv-torch-v0", entry_point=_entry)


_register_gym()
