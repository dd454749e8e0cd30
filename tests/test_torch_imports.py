"""The port stands alone: no module of ``torchdriveenv_tpu_torch`` and not
``chip_smoke.py`` imports JAX, Flax or the JAX package."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "chex", "orbax",
             "torchdriveenv_tpu")


def _sources():
    pkg = os.path.join(ROOT, "torchdriveenv_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_package_has_the_slice_modules():
    rel = {os.path.relpath(p, ROOT) for p in _sources()}
    for mod in ("__init__", "config", "bench", "maps/arrays", "ops/bicycle",
                "ops/collision", "ops/traffic_lights", "ops/offroad",
                "ops/waypoints", "npc/route_follow", "env/core",
                "ops/rasterizer", "ops/rasterizer_cuda", "ops/_build",
                "env/batched", "models/__init__", "models/cnn",
                "models/policies", "models/convert", "rl/rollout",
                "rl/buffer", "rl/sac", "rl/demo", "rl/evaluate",
                "parallel/train_step", "rl/optim", "rl/ppo", "rl/a2c",
                "rl/td3", "rl/train", "utils/__init__", "utils/video",
                "npc/policy_net", "env/gym_adapter", "utils/seeding",
                "parallel/mesh", "maps/compile", "data_utils",
                "tools/__init__", "tools/distill_npc", "tools/bc_pretrain",
                "tools/eval_checkpoints", "tools/profile_learner",
                "tools/profile_step", "tools/diagnose_val",
                "tools/audit_map_fidelity", "examples/__init__",
                "examples/evaluate_policy", "examples/rollout_example"):
        assert f"torchdriveenv_tpu_torch/{mod}.py" in rel, mod
    for data in ("csrc/rasterizer.cu", "examples/train_gpu.sh",
                 "assets/deliverable_sac_stage1_actor.npz",
                 "assets/npc_gru_v1.npz"):
        assert os.path.exists(os.path.join(ROOT, "torchdriveenv_tpu_torch",
                                           data)), data


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for name in _imported(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def _module_level_imports(tree):
    """Imports that run when the module is imported (not inside a def)."""
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        stack.extend(ast.iter_child_nodes(node))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_optional_packages_are_imported_inside_functions(path):
    """PyYAML, PIL, TensorBoard and wandb are not promised on the GPU
    machine: no module needs them to be imported, only the function that
    uses them (``config.py`` imports without ``yaml``, ``rl/train.py``
    without a log sink, ``utils/video.py`` without ``PIL``)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for name in _module_level_imports(tree):
        assert name.split(".")[0] not in ("yaml", "PIL", "tensorboard",
                                          "wandb"), f"{path} imports {name}"
        assert name != "torch.utils.tensorboard", path
