"""The float32 precision every entry point of the port runs at.

torch's defaults let cuDNN run float32 convolutions in TF32 (10-bit
mantissas). The port is held to the JAX package in float32 on the CPU and
on the card, so every entry point (the CLI, the tools, the examples, the
benchmark) switches TF32 off for matrix products and convolutions alike.
bf16 torsos (``compute_dtype``) are the recipes' own choice and stay as
they are.
"""

from __future__ import annotations

import torch


def set_f32_precision() -> None:
    """Float32 matrix products and convolutions without TF32. On the CPU the
    flags change nothing."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
