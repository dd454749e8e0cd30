"""NatureCNN image torso (the benchmark's reference: a frozen copy of the
port's ``models/cnn.py``).

conv 32x8x8/4 - conv 64x4x4/2 - conv 64x3x3/1 - fc 512, ReLU throughout,
uint8 NCHW input scaled to [0, 1], f32 output.

Padding follows the JAX module: none ("VALID") for inputs of 36 pixels and
more, XLA's "SAME" below that. SAME with a stride pads unevenly (the low
side gets the smaller half), which ``nn.Conv2d(padding=...)`` cannot
express, so it is an explicit ``F.pad`` before an unpadded convolution.

``compute_dtype=torch.bfloat16`` (the default, like the JAX module) runs
the torso under autocast with f32 parameters; ``torch.float32`` runs it
plainly.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .arrays import exact_div

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

    def _torso(self, x: torch.Tensor) -> torch.Tensor:
        same = x.shape[-1] < VALID_MIN_RES
        for conv, (kernel, stride) in zip((self.conv1, self.conv2, self.conv3),
                                          _CONVS):
            if same:
                ph = same_padding(x.shape[-2], kernel, stride)
                pw = same_padding(x.shape[-1], kernel, stride)
                x = F.pad(x, pw + ph)
            x = F.relu(conv(x))
        return F.relu(self.fc(x.flatten(1)))

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return self._torso(exact_div(obs.to(torch.float32), 255.0))
        with torch.autocast(obs.device.type, dtype=self.compute_dtype):
            x = self._torso(exact_div(obs.to(self.compute_dtype), 255.0))
        return x.to(torch.float32)
