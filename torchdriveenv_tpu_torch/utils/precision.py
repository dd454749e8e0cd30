"""The float32 precision every entry point of the port runs at.

torch's defaults let cuDNN run float32 convolutions in TF32 (10-bit
mantissas). The port is held to the JAX package in float32 on the CPU and
on the card, so the CLI, the tools, the examples and the bench switch TF32
off for matrix products and convolutions alike. bf16 torsos
(``compute_dtype``) are the recipes' own choice and stay as they are.
"""

from __future__ import annotations

import torch


def set_f32_precision(cudnn_tf32: bool = False) -> None:
    """Float32 matrix products and convolutions without TF32. On the CPU the
    flags change nothing. ``cudnn_tf32=True`` gives back torch's default for
    convolutions (TF32 in cuDNN), the setting the CLI ran at before it
    called this; only a comparison of the two settings asks for it."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = cudnn_tf32
