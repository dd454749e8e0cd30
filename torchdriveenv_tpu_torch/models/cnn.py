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
its last convolution, its input made by the hand-written kernel
``csrc/torso_input.cu`` (``torso_input_cuda``; ``nhwc_input`` is its plain
twin): cuDNN's bf16 tensor-op convolutions run NHWC, and
handed NCHW tensors they transpose every input, weight and output, forward
and backward. conv1's 9 input channels stay 9: cuDNN pads them to 16
itself and runs the kernels it runs for the NCHW torso, with their
rounding (handed 16 channels it picks others, whose rounding Adam
compounds). The parameters, their gradients and every checkpoint keep
their contiguous f32 NCHW layout; on the CPU the torso runs NCHW.

A learner that hands one stack to several torsos makes their input once
(``torso_input``) and hands that to each: ``forward`` takes the uint8
stack or an input already made.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchdriveenv_tpu_torch.maps.arrays import device_constant, exact_div
from torchdriveenv_tpu_torch.ops import _build

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
    tensor, in one torch pass that writes the layout, the cast and the
    division together: the plain twin of ``torso_input_cuda``, which the
    card runs. The divisor is a tensor, so the division rounds once, as
    ``exact_div``'s."""
    x = torch.empty(obs.shape, dtype=dtype, device=obs.device,
                    memory_format=torch.channels_last)
    return torch.div(obs, device_constant(255.0, obs.device, dtype), out=x)


# the band of image rows a block of the kernel takes: the most, a power of
# two, whose planes fit in this many bytes of shared memory
_BAND_BYTES = 8192
_check = functools.partial(_build.check_tensor, "torso_input_cuda")


def torso_input_cuda(obs: torch.Tensor) -> torch.Tensor:
    """Launch the kernel of ``csrc/torso_input.cu`` on a CUDA uint8 stack
    (B, C, H, W), contiguous, on the current stream -> ``obs / 255`` as a
    bf16 channels-last tensor: what ``nhwc_input(obs, torch.bfloat16)``
    returns, bit for bit, strides included. A stack of no rows launches
    nothing. Raises on a tensor elsewhere than the GPU, on any other dtype,
    rank or layout, on a failed build and on a failed launch.
    ``torso_input_cuda.launches`` counts the launches from the host."""
    dev = obs.device
    if dev.type != "cuda":
        raise ValueError("torso_input_cuda needs a CUDA tensor; got "
                         f"{dev} (use nhwc_input on the CPU)")
    if obs.dim() != 4:
        raise ValueError("torso_input_cuda: obs must be (B, C, H, W); got "
                         f"{tuple(obs.shape)}")
    _check("obs", obs, torch.uint8, obs.shape, dev)
    b, c, h, w = obs.shape
    out = torch.empty(obs.shape, dtype=torch.bfloat16, device=dev,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    fit = max(_BAND_BYTES // (c * w), 1)
    rows = min(1 << (fit.bit_length() - 1), h)
    lib = _build.load_torso_input()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.tde_torso_input(
            obs.data_ptr(), out.data_ptr(), b, c, h, w, rows,
            int(w % 16 == 0 and obs.data_ptr() % 16 == 0),
            int(w * c % 8 == 0 and out.data_ptr() % 16 == 0), stream)
    if rc != 0:
        raise RuntimeError(f"torso_input kernel launch failed: CUDA error "
                           f"{rc} ({lib.tde_torso_input_error_string(rc).decode()})")
    torso_input_cuda.launches += 1
    return out


torso_input_cuda.launches = 0   # kernel launches since the last reset to 0


def torso_input(obs: torch.Tensor, dtype) -> torch.Tensor:
    """The uint8 stack (B, C, H, W) as the torso of ``compute_dtype``
    ``dtype`` takes it: ``obs / 255`` in ``dtype``; on a CUDA card in bf16
    channels-last, by the kernel; elsewhere NCHW, ``exact_div``'s division.
    ``NatureCNN.forward`` makes it from a uint8 stack; a learner that hands
    one stack to several torsos makes it once and hands it to each."""
    obs = obs.contiguous()
    if _channels_last(obs, dtype):
        return torso_input_cuda(obs)
    return exact_div(obs.to(dtype), 255.0)


def _channels_last(obs: torch.Tensor, dtype) -> bool:
    """Whether the torso of ``dtype`` runs channels-last on ``obs``'s
    device: the bf16 torso on a CUDA card."""
    return obs.is_cuda and dtype == torch.bfloat16


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
    """obs (B, C, H, W) uint8 (or its ``torso_input``), C = 3 * frame_stack
    -> (B, features) f32."""

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
        """``obs``: the uint8 stack, or ``torso_input(stack,
        self.compute_dtype)`` made once for several torsos. Raises
        ``TypeError`` on any other input: one of another dtype, or not in the
        layout ``torso_input`` makes on its device (channels-last on the
        card in bf16, contiguous NCHW elsewhere)."""
        dtype = self.compute_dtype
        nhwc = _channels_last(obs, dtype)
        if obs.dtype == torch.uint8:
            obs = torso_input(obs, dtype)
        elif obs.dtype != dtype or not obs.is_contiguous(
                memory_format=(torch.channels_last if nhwc
                               else torch.contiguous_format)):
            raise TypeError(
                f"NatureCNN: a {obs.dtype} input of strides {obs.stride()} "
                f"to a {dtype} torso on {obs.device}; pass the uint8 stack "
                "or torso_input(stack, compute_dtype)")
        return self._run(obs, nhwc)

    def _run(self, x: torch.Tensor, nhwc: bool) -> torch.Tensor:
        """The torso on its input made (``obs / 255`` in
        ``compute_dtype``), channels-last (``nhwc``) or NCHW."""
        dtype = self.compute_dtype
        if dtype == torch.float32:
            return self._torso(x, nhwc)
        with torch.autocast(x.device.type, dtype=dtype):
            x = self._torso(x, nhwc)
        return x.to(torch.float32)
