"""The rasterizer's CUDA kernel (``csrc/rasterizer.cu``) against its plain
torch twin ``render_obs_torch``, on the card: bit for bit.

This module imports nothing of JAX, so it runs on a GPU machine that has no
JAX or Flax (the twin is held to the JAX package on the CPU in
``tests/test_torch_rasterizer.py``). Every case skips without a CUDA device:
the kernel has no CPU mode. On the card, from the repository root (the
``--noconftest`` keeps the test configuration, which imports JAX, out):

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_rasterizer_cuda.py -m cuda
"""

import pytest
import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import load_assets
from torchdriveenv_tpu_torch.ops import rasterizer_cuda as trc


@pytest.mark.cuda
@pytest.mark.parametrize("left_handed,highlight_ego,ego_only",
                         [(True, True, False), (False, False, False),
                          (True, True, True)])
def test_kernel_matches_twin_on_gpu(left_handed, highlight_ego, ego_only):
    """The CUDA kernel is bit-equal to the twin on 64 validation envs after
    4 steps, and counts its launch (runs only on a GPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    assets = load_assets("val", device="cuda")
    reset_fn, step_fn = make_env_fns(EnvConfig(ego_only=ego_only), assets,
                                     render=False)
    g = torch.Generator(device="cuda").manual_seed(0)
    state, _ = reset_fn(g, 64)
    for _ in range(4):
        state = step_fn(state, torch.tensor([[0.4, 0.05]], device="cuda")
                        .repeat(64, 1), g).state
    t = state.time0 + state.step_idx.float() * 0.1
    case = state.case.long()
    prep = trc.prepare_obs_inputs(
        assets.maps, state.town, t, state.agent_states, state.agent_attrs,
        state.present, assets.suite.waypoints[case], state.target_idx,
        assets.suite.n_waypoints[case], fov=70.0)
    kw = dict(left_handed=left_handed, highlight_ego=highlight_ego)
    before = trc.render_obs_cuda.launches
    kern = trc.render_obs_cuda(assets.maps, state.town, *prep, **kw)
    twin = trc.render_obs_torch(assets.maps, state.town, *prep, **kw)
    torch.cuda.synchronize()
    assert trc.render_obs_cuda.launches == before + 1
    assert kern.shape == (64, 3, 64, 64) and kern.dtype == torch.uint8
    assert torch.equal(kern, twin)
