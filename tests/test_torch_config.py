"""The port's training configs and YAML loaders (``config.py``) against the
JAX package's: every YAML file under ``examples/env_configs/`` and every
``artifacts/*_run.yml`` loads through both packages to configs that are
equal field by field; an unknown field raises ``TypeError``; a parsed dict
becomes a config without PyYAML; and the recipe dicts ``chip_smoke.py``
trains from equal the files they name.
"""

import dataclasses
import glob
import importlib
import os
import subprocess
import sys

import pytest
import yaml

from torchdriveenv_tpu import config as jc
from torchdriveenv_tpu_torch import config as tc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(
    os.path.relpath(p, ROOT) for p in
    glob.glob(os.path.join(ROOT, "examples", "env_configs", "*", "*.yml"))
    + glob.glob(os.path.join(ROOT, "artifacts", "*_run.yml")))


def _plain(cfg):
    """``asdict`` with enums by value (the two packages have their own)."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        return getattr(x, "value", x)
    return walk(dataclasses.asdict(cfg))


def test_the_repo_has_the_yaml_files():
    assert len(YAMLS) >= 21, YAMLS
    assert "examples/env_configs/tpu_scale/ppo_1024.yml" in YAMLS
    assert "artifacts/sac_stage1_run.yml" in YAMLS


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_loads_to_the_same_config_in_both_packages(path):
    full = os.path.join(ROOT, path)
    j, t = jc.load_rl_training_config(full), tc.load_rl_training_config(full)
    assert _plain(t) == _plain(j)
    assert isinstance(t.algorithm, tc.BaselineAlgorithm)
    assert isinstance(t.total_timesteps, int) and t.total_timesteps > 0
    assert isinstance(t.env, tc.EnvConfig)
    assert isinstance(t.env.simulator.renderer, tc.RendererConfig)
    assert isinstance(t.eval_val_callback, tc.RlCallbackConfig)
    assert isinstance(t.wandb_callback, tc.WandbCallbackConfig)
    # the env section alone, through the env loader's dict half
    with open(full) as f:
        raw = yaml.safe_load(f)
    assert _plain(tc.construct_env_config(raw.get("env"))) == \
        _plain(jc.construct_env_config(raw.get("env")))


@pytest.mark.parametrize("name", ["RlCallbackConfig", "WandbCallbackConfig",
                                  "RlTrainingConfig", "BaselineAlgorithm"])
def test_training_configs_copy_the_jax_fields_and_defaults(name):
    j, t = getattr(jc, name), getattr(tc, name)
    if name == "BaselineAlgorithm":
        assert [m.value for m in j] == [m.value for m in t]
        return
    assert [f.name for f in dataclasses.fields(j)] == \
        [f.name for f in dataclasses.fields(t)]
    assert _plain(j()) == _plain(t())


def test_unknown_fields_raise(tmp_path):
    with pytest.raises(TypeError, match="Unknown config field 'n_envs'"):
        tc.construct_rl_training_config({"algorithm": "ppo", "n_envs": 4})
    with pytest.raises(TypeError, match="RendererConfig"):
        tc.construct_env_config({"simulator": {"renderer": {"fov": 70}}})
    bad = tmp_path / "bad.yml"
    bad.write_text("algorithm: sac\nenv:\n  egos_only: true\n")
    with pytest.raises(TypeError, match="egos_only"):
        tc.load_rl_training_config(str(bad))
    with pytest.raises(ValueError):
        tc.construct_rl_training_config({"algorithm": "dqn"})


def test_env_yaml_and_defaults(tmp_path):
    p = tmp_path / "env.yml"
    p.write_text("ego_only: true\nsimulator:\n  collision_metric: discs\n"
                 "  renderer:\n    obs_res: 20\n")
    cfg = tc.load_env_config(str(p))
    assert cfg.ego_only and cfg.simulator.renderer.obs_res == 20
    assert cfg.simulator.collision_metric is tc.CollisionMetric.discs
    assert _plain(cfg) == _plain(jc.load_env_config(str(p)))
    assert _plain(tc.construct_rl_training_config(None)) == \
        _plain(tc.RlTrainingConfig(total_timesteps=5000000))
    # dataclasses pass through; total_timesteps takes YAML's "5e7" string
    env = tc.EnvConfig(frame_stack=2)
    cfg = tc.construct_rl_training_config({"env": env,
                                           "total_timesteps": "5e7"})
    assert cfg.env is env and cfg.total_timesteps == 50_000_000


def test_a_dict_becomes_a_config_without_pyyaml():
    """``config.py`` imports without PyYAML, and only the functions that
    open a file need it. In a fresh interpreter where ``import yaml``
    fails."""
    code = """
import sys
sys.modules["yaml"] = None              # import yaml now raises ImportError
from torchdriveenv_tpu_torch import config
cfg = config.construct_rl_training_config(
    {"algorithm": "td3", "parallel_env_num": 10, "total_timesteps": "2e6",
     "env": {"distance_cutoff": 0.25}})
assert cfg.algorithm.value == "td3" and cfg.env.distance_cutoff == 0.25
assert cfg.total_timesteps == 2000000
try:
    config.load_rl_training_config("artifacts/td3_short_run.yml")
except ImportError:
    print("needs yaml only to open a file")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "needs yaml only to open a file"


def test_chip_smoke_recipes_equal_their_files():
    sys.path.insert(0, ROOT)
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(ROOT)
    assert sorted(chip_smoke.RECIPES) == sorted(
        [chip_smoke.PPO_YML, chip_smoke.A2C_YML, chip_smoke.TD3_YML,
         chip_smoke.SAC_YML, chip_smoke.NPC_SAC_YML])
    for path, raw in chip_smoke.RECIPES.items():
        with open(os.path.join(ROOT, path)) as f:
            assert raw == yaml.safe_load(f), path
        assert _plain(tc.construct_rl_training_config(
            {k: (dict(v) if isinstance(v, dict) else v)
             for k, v in raw.items()})) == \
            _plain(jc.load_rl_training_config(os.path.join(ROOT, path)))
    # the [learner] phase's sizes are read from the SAC recipe
    assert chip_smoke.RECIPE_ENVS == 128 and chip_smoke.RECIPE_CAPACITY == 3125
    assert chip_smoke.RECIPE_BATCH == 512 and chip_smoke.RECIPE_SEED == 29
