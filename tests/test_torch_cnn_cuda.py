"""The NatureCNN torso's channels-last bf16 path on the card: one SAC update
at batch 512 runs no cuDNN layout conversion, and gives the losses of the
same update with NCHW torsos to rounding.

This module imports nothing of JAX, so it runs on a GPU machine that has no
JAX or Flax (the torso is held to the JAX package on the CPU in
``tests/test_torch_models.py``). Every case skips without a CUDA device: the
path runs only there. On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_cnn_cuda.py -m cuda
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torchdriveenv_tpu_torch.maps.arrays import exact_div
from torchdriveenv_tpu_torch.models import cnn
from torchdriveenv_tpu_torch.rl import sac
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

B = 512
CONVERSIONS = ("nchwToNhwc", "nhwcToNchw")


def _batch(seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    stack = (B, 9, 64, 64)
    return dict(
        obs=torch.randint(0, 256, stack, generator=g, dtype=torch.uint8,
                          device="cuda"),
        next_obs=torch.randint(0, 256, stack, generator=g, dtype=torch.uint8,
                               device="cuda"),
        action=torch.rand((B, 2), generator=g, device="cuda") * 2 - 1,
        reward=torch.randn(B, generator=g, device="cuda"),
        discount_mask=torch.ones(B, device="cuda"),
        pos=torch.arange(B, device="cuda"))


def _second_update(monkeypatch, nhwc):
    """A fresh bf16 agent's second update on a fixed batch and noise, under
    torch.profiler -> (its metrics, the kernel names of the trace, the
    agent)."""
    with monkeypatch.context() as m:
        if not nhwc:
            # the update makes the NCHW input, as the torso did before
            m.setattr(sac, "torso_input",
                      lambda obs, dtype: exact_div(obs.to(dtype), 255.0))
            m.setattr(cnn.NatureCNN, "forward",
                      lambda self, obs: self._run(obs, nhwc=False))
        agent = sac.SAC(sac.SACConfig(batch_size=B))
        agent.init(seed=0, device="cuda")
        for i in range(2):
            batch = _batch(i)
            noise = [torch.randn((B, 2), device="cuda",
                                 generator=torch.Generator(
                                     device="cuda").manual_seed(10 + i + k))
                     for k in (0, 1)]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                out = agent.update(batch, noise=noise)
                torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return {k: float(v) for k, v in out.items()}, names, agent


@pytest.mark.cuda
def test_bf16_update_runs_no_layout_conversion(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the channels-last path runs only "
                    "there")
    set_f32_precision()
    got, names, agent = _second_update(monkeypatch, nhwc=True)
    want, nchw_names, _ = _second_update(monkeypatch, nhwc=False)
    assert names and any("conv" in n.lower() or "fprop" in n for n in names)
    assert not [n for n in names if any(c in n for c in CONVERSIONS)]
    # the NCHW run converts: the check above can see a conversion
    assert [n for n in nchw_names if any(c in n for c in CONVERSIONS)]
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-3 * max(abs(v), 1.0), (k, got[k], v)
    st = agent.state
    for opt in (st.actor_opt, st.critic_opt):
        for p, s in opt.state.items():
            for t in (p, s["exp_avg"], s["exp_avg_sq"]):
                assert t.dtype == torch.float32 and t.is_contiguous()
