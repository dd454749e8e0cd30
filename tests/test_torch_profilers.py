"""The port's profilers, ``tools/profile_learner.py`` and
``tools/profile_step.py``, run with ``--device cpu`` at a tiny size: each
writes a report with every section (on the CPU its times are the host's
clock, and launches and shares of the H100's peaks are not measured). The
FLOP count of an update grows with its batch; no TPU constant is carried
into the port."""

import json
import os

import pytest
import torch

from torchdriveenv_tpu_torch.tools import profile_learner, profile_step

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_profile_learner_reports_every_section(tmp_path, monkeypatch):
    """``main`` sizes the ring by ``SACConfig().buffer_size``, as the JAX
    tool does (1.2 GB at 2 envs); here the ring it asks for is noted and
    a 512-transition one is profiled in its place."""
    from torchdriveenv_tpu_torch.rl.sac import SACConfig
    plain, asked = profile_learner.profile, []

    def small_ring(*args):
        asked.append(args[5])
        return plain(*args[:5], 512, *args[6:])

    monkeypatch.setattr(profile_learner, "profile", small_ring)
    out = tmp_path / "learner.json"
    report = profile_learner.main([
        "--device", "cpu", "--num_envs", "2", "--batches", "4", "8",
        "--batch_size", "4", "--updates_per_iter", "2", "--steps_per_iter",
        "2", "--out", str(out)])
    assert asked == [SACConfig().buffer_size]
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(report))
    for k in ("update_sweep", "sample_sweep", "buffer", "learn_phase",
              "rollout_phase", "fused_train_step"):
        assert k in report, k
    assert report["device"] == "cpu" and report["card"] == "cpu"
    assert report["clock"] == "host"
    sweep = report["update_sweep"]
    assert sorted(sweep) == [4, 8] and sorted(report["sample_sweep"]) == [4, 8]
    for row in sweep.values():
        assert row["ms"] > 0 and row["launches"] is None
        assert row["tensor_share_of_bf16_peak"] is None
        assert row["min_bytes"] > 2 * 9 * 64 * 64
    # the convolutions' and products' work scales with the batch
    assert sweep[8]["flops"] == pytest.approx(2 * sweep[4]["flops"], rel=0.02)
    assert report["buffer"] == dict(capacity_per_env=256, envs=2,
                                    frames_gb=2 * 256 * 3 * 64 * 64 / 1e9)
    for k in ("learn_phase", "rollout_phase", "fused_train_step"):
        assert report[k]["ms"] > 0 and report[k]["launches"] is None, k
    assert report["fused_train_step"]["env_steps_per_iter"] == 4


def test_update_flops_count_the_networks():
    """One update's FLOPs: the forward and backward passes of the critic
    and the actor, about 3 x 2 x multiply-adds of the torsos per sample."""
    from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
    agent = SAC(SACConfig(batch_size=4), compute_dtype=torch.float32)
    agent.init(device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = profile_learner.synthetic_batch(4, g, "cpu")
    flops = profile_learner.update_flops(agent, batch, g)
    # NatureCNN at 64 px: conv1 9->32 8x8/4 (15x15), conv2 32->64 4x4/2
    # (6x6), conv3 64->64 3x3 (4x4), fc 1024->512: multiply-adds per sample
    macs = (15 * 15 * 32 * 9 * 64 + 6 * 6 * 64 * 32 * 16
            + 4 * 4 * 64 * 64 * 9 + 1024 * 512)
    # torsos: actor forward on next_obs and obs (2), target critic's two
    # (2), critic's two (2) + its backward (x2 more), actor backward through
    # the critic's two torsos and its own: between 8 and 20 passes
    assert 8 * 2 * macs * 4 < flops < 20 * 2 * macs * 4


def test_profile_step_reports_every_piece(tmp_path):
    out = tmp_path / "step.json"
    report = profile_step.main(["--device", "cpu", "--num_envs", "4",
                                "--out", str(out)])
    with open(out) as f:
        assert json.load(f) == report
    assert sorted(report["ms"]) == sorted([
        "full step (render)", "full step (no render)", "reset only",
        "core.step only (no autoreset)", "npc_actions", "render_egocentric",
        "render (road=const, no SDF gather)",
        "render_observation (kernel path)"])
    assert all(v > 0 for v in report["ms"].values())
    assert report["device"] == "cpu" and report["num_envs"] == 4


def test_profile_step_restores_the_sdf_sampler():
    from torchdriveenv_tpu_torch.ops import rasterizer
    plain = rasterizer.sample_sdf_nearest
    profile_step.profile(2, "cpu", iters=1)
    assert rasterizer.sample_sdf_nearest is plain


@pytest.mark.parametrize("tool", [profile_learner, profile_step])
def test_the_profilers_need_a_gpu_or_device_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main([])


def test_no_tpu_constant_in_the_port():
    for d, _, files in os.walk(os.path.join(ROOT, "torchdriveenv_tpu_torch")):
        for name in files:
            if name.endswith((".py", ".sh", ".cu")):
                with open(os.path.join(d, name)) as f:
                    assert "V5E" not in f.read(), os.path.join(d, name)
    assert profile_learner.H100_PEAK_BF16_FLOPS == 989e12
    assert profile_learner.H100_PEAK_HBM_BYTES == 3.35e12
