"""NatureCNN image torso (port of ``torchdriveenv_tpu/models/cnn.py``).

conv 32x8x8/4 - conv 64x4x4/2 - conv 64x3x3/1 - fc 512, ReLU throughout,
uint8 NCHW input scaled to [0, 1], f32 output.

Padding follows the JAX module: none ("VALID") for inputs of 36 pixels and
more, XLA's "SAME" below that. SAME with a stride pads unevenly (the low
side gets the smaller half), which ``nn.Conv2d(padding=...)`` cannot
express, so it is an explicit ``F.pad`` before an unpadded convolution.

``compute_dtype=torch.bfloat16`` (the default, like the JAX module) runs
the torso under autocast with f32 parameters; ``torch.float32`` runs it
plainly.

On a CUDA card the bf16 torso runs channels-last (NHWC) from its input to
its last convolution: cuDNN's bf16 tensor-op convolutions run NHWC, and
handed NCHW tensors they transpose every input, weight and output, forward
and backward. conv1's 9 input channels stay 9: cuDNN pads them to 16
itself and runs the kernels it runs for the NCHW torso, with their
rounding (handed 16 channels it picks others, whose rounding Adam
compounds). The parameters, their gradients and every checkpoint keep
their contiguous f32 NCHW layout; on the CPU the torso runs NCHW.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchdriveenv_tpu_torch.maps.arrays import device_constant, exact_div

VALID_MIN_RES = 36      # below this width the convolutions pad "SAME"
_CONVS = ((8, 4), (4, 2), (3, 1))   # (kernel, stride) of conv1..conv3


def same_padding(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis -> (low, high)."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2


def conv_out_res(obs_res: int) -> int:
    """Side of the map that conv3 leaves for a square input."""
    n = obs_res
    for kernel, stride in _CONVS:
        if obs_res >= VALID_MIN_RES:
            n = (n - kernel) // stride + 1
        else:
            n = -(-n // stride)
    return n


def flax_default_init_(module: nn.Module) -> None:
    """Initialise every convolution and dense layer under ``module`` as the
    JAX package's layers start: LeCun-normal kernels (a normal truncated at
    two standard deviations, variance 1 / fan_in) and zero biases."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2.0 * std, b=2.0 * std)
            nn.init.zeros_(m.bias)


def nhwc_input(obs: torch.Tensor, dtype) -> torch.Tensor:
    """uint8 (B, C, H, W) -> ``obs / 255`` in ``dtype`` as a channels-last
    tensor, in one pass that reads each byte of the stack once and writes
    the layout, the cast and the division together. The divisor is a
    tensor, so the division rounds once, as ``exact_div``'s."""
    x = torch.empty(obs.shape, dtype=dtype, device=obs.device,
                    memory_format=torch.channels_last)
    return torch.div(obs, device_constant(255.0, obs.device, dtype), out=x)


class _NhwcWeight(torch.autograd.Function):
    """A convolution's weight as the channels-last ``dtype`` tensor cuDNN's
    NHWC kernels read, in one pass (autocast's own cast makes one too).
    The gradient comes back in the parameter's dtype and contiguous layout;
    through a plain ``.to`` it would keep the channels-last layout of
    cuDNN's weight gradient."""

    @staticmethod
    def forward(ctx, w, dtype):
        ctx.dtype = w.dtype
        return w.to(dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype, memory_format=torch.contiguous_format), None


class _NhwcBias(torch.autograd.Function):
    """``x + b`` over the channels of a channels-last map, as the
    convolution adds its bias. The gradient of ``b`` is summed over an NCHW
    copy of the map's gradient: the order, and so the bf16 rounding, of the
    NCHW torso's sum (a sum over the channels-last map rounds a few of
    them otherwise, which Adam compounds over the updates)."""

    @staticmethod
    def forward(ctx, x, b):
        ctx.dtype = b.dtype
        return x + b.to(x.dtype).view(1, -1, 1, 1)

    @staticmethod
    def backward(ctx, grad):
        return grad, grad.contiguous().sum((0, 2, 3)).to(ctx.dtype)


class NatureCNN(nn.Module):
    """obs (B, C, H, W) uint8, C = 3 * frame_stack -> (B, features) f32."""

    def __init__(self, in_channels: int, features: int = 512,
                 obs_res: int = 64, compute_dtype=torch.bfloat16):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(in_channels, 32, 8, stride=4)
        self.conv2 = nn.Conv2d(32, 64, 4, stride=2)
        self.conv3 = nn.Conv2d(64, 64, 3, stride=1)
        self.fc = nn.Linear(64 * conv_out_res(obs_res) ** 2, features)
        flax_default_init_(self)

    def _torso(self, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
        same = x.shape[-1] < VALID_MIN_RES
        for conv, (kernel, stride) in zip((self.conv1, self.conv2, self.conv3),
                                          _CONVS):
            if same:        # F.pad keeps the channels-last layout
                ph = same_padding(x.shape[-2], kernel, stride)
                pw = same_padding(x.shape[-1], kernel, stride)
                x = F.pad(x, pw + ph)
            if nhwc:
                w = _NhwcWeight.apply(conv.weight, x.dtype)
                x = _NhwcBias.apply(F.conv2d(x, w, None, stride), conv.bias)
            else:
                x = F.conv2d(x, conv.weight, conv.bias, stride)
            x = F.relu(x)
        # on a channels-last map the flatten copies into the (C, H, W) order
        # that ``fc`` (and the JAX checkpoints) expect
        return F.relu(self.fc(x.flatten(1)))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self._run(obs, nhwc=obs.is_cuda
                         and self.compute_dtype == torch.bfloat16)

    def _run(self, obs: torch.Tensor, nhwc: bool) -> torch.Tensor:
        """The torso, channels-last (``nhwc``) or NCHW."""
        dtype = self.compute_dtype
        x = (nhwc_input(obs, dtype) if nhwc
             else exact_div(obs.to(dtype), 255.0))
        if dtype == torch.float32:
            return self._torso(x, nhwc)
        with torch.autocast(obs.device.type, dtype=dtype):
            x = self._torso(x, nhwc)
        return x.to(torch.float32)
