"""The torso input's CUDA kernel (``csrc/torso_input.cu``, through
``models/cnn.py:torso_input_cuda``) against its plain twin ``nhwc_input``
on the card: bit for bit, with the twin's strides, for every byte value; a
stack of no rows launches nothing; a SAC update launches it twice; a
bf16 torso on the card takes no input in another layout.

This module imports nothing of JAX, so it runs on a GPU machine that has no
JAX or Flax (the twin is held to ``exact_div`` and the JAX package on the
CPU in ``tests/test_torch_models.py``). Every case skips without a CUDA
device: the kernel has no CPU mode. On the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_torso_input_cuda.py -m cuda
"""

import pytest
import torch

from torchdriveenv_tpu_torch.models import cnn
from torchdriveenv_tpu_torch.rl import sac

# SAC's batch, PPO's rows a card at four cards and at one, an odd batch; a
# side that is no multiple of 16 (byte loads) and a C x W that is no
# multiple of 8 (value stores)
SHAPES = [(512, 9, 64, 64), (2048, 9, 64, 64), (4096, 9, 64, 64),
          (37, 9, 64, 64), (5, 9, 20, 20), (3, 3, 7, 9)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _stack(shape, dev, seed=0):
    """Every byte value in the first 256 elements, the rest drawn."""
    g = torch.Generator(device=dev).manual_seed(seed)
    obs = torch.randint(0, 256, shape, generator=g, dtype=torch.uint8,
                        device=dev)
    n = min(256, obs.numel())
    obs.view(-1)[:n] = torch.arange(n, device=dev).to(torch.uint8)
    return obs


def _assert_twin(obs):
    before = cnn.torso_input_cuda.launches
    got = cnn.torso_input_cuda(obs)
    want = cnn.nhwc_input(obs, torch.bfloat16)
    torch.cuda.synchronize()
    assert cnn.torso_input_cuda.launches == before + 1
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == want.shape and got.stride() == want.stride()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
def test_every_byte_value_equals_the_twin(card):
    obs = torch.arange(256, device=card).to(torch.uint8).reshape(1, 1, 16, 16)
    _assert_twin(obs.expand(2, 9, 16, 16).contiguous())
    _assert_twin(torch.arange(256, device=card).to(torch.uint8)
                 .reshape(4, 4, 4, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernel_equals_the_twin(card, shape):
    _assert_twin(_stack(shape, card))


@pytest.mark.cuda
def test_a_stack_off_16_byte_alignment_equals_the_twin(card):
    flat = _stack((1 + 6 * 9 * 64 * 64,), card, seed=1)
    _assert_twin(flat[1:].view(6, 9, 64, 64))


@pytest.mark.cuda
def test_no_rows_launch_nothing(card):
    before = cnn.torso_input_cuda.launches
    out = cnn.torso_input_cuda(torch.empty((0, 9, 64, 64), dtype=torch.uint8,
                                           device=card))
    torch.cuda.synchronize()
    assert cnn.torso_input_cuda.launches == before
    assert out.shape == (0, 9, 64, 64) and out.dtype == torch.bfloat16


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(card):
    obs = _stack((4, 9, 64, 64), card)
    with pytest.raises(TypeError):
        cnn.torso_input_cuda(obs.float())
    with pytest.raises(ValueError):
        cnn.torso_input_cuda(obs.transpose(2, 3))
    with pytest.raises(ValueError):
        cnn.torso_input_cuda(obs[0])


@pytest.mark.cuda
def test_a_sac_update_launches_it_once_a_stack(card):
    b = 64
    g = torch.Generator(device=card).manual_seed(3)
    batch = dict(
        obs=torch.randint(0, 256, (b, 9, 64, 64), generator=g,
                          dtype=torch.uint8, device=card),
        next_obs=torch.randint(0, 256, (b, 9, 64, 64), generator=g,
                               dtype=torch.uint8, device=card),
        action=torch.rand((b, 2), generator=g, device=card) * 2 - 1,
        reward=torch.randn(b, generator=g, device=card),
        discount_mask=torch.ones(b, device=card),
        pos=torch.arange(b, device=card))
    agent = sac.SAC(sac.SACConfig(batch_size=b))
    agent.init(seed=0, device=card)
    before = cnn.torso_input_cuda.launches
    agent.update(batch, generator=torch.Generator(device=card).manual_seed(4))
    assert cnn.torso_input_cuda.launches == before + 2
    agent.select_action(batch["obs"][:8])
    torch.cuda.synchronize()
    assert cnn.torso_input_cuda.launches == before + 3


@pytest.mark.cuda
def test_a_bf16_torso_takes_only_the_channels_last_input(card):
    torso = cnn.NatureCNN(9).to(card)
    obs = _stack((4, 9, 64, 64), card)
    x = cnn.torso_input(obs, torch.bfloat16)
    assert x.is_contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        assert torch.equal(torso(x), torso(obs))
        with pytest.raises(TypeError, match="torso_input"):
            torso(x.contiguous())       # NCHW: cuDNN would convert it
