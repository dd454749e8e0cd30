"""Seeding helper (the port's copy of ``torchdriveenv_tpu/utils/seeding.py``;
reference helpers.py:39-49).

Seeds the host-side RNGs (numpy, ``random``) and returns the seed, from
which callers seed their own ``torch.Generator``.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np


def set_seeds(seed: Optional[int], logger=None) -> int:
    if seed is None:
        seed = int(np.random.randint(low=0, high=2**31 - 1))
    if logger is not None:
        logger.info(f"seed: {seed}")
    np.random.seed(seed)
    random.seed(seed)
    return seed
