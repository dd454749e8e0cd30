"""Lower precision for the controls: under ``LowerPrecision(f32_to,
bf16_to)`` every float32 result of every torch operation is rounded to
``f32_to`` and every bfloat16 result to ``bf16_to`` (each stored back in
its own dtype), so a reference run under it computes in the next lower
precision, operation by operation, as a port that lowered its precision
would. Views are left alone; what an in-place operation writes is rounded
in place."""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map


class LowerPrecision(TorchDispatchMode):
    def __init__(self, f32_to: torch.dtype = torch.bfloat16,
                 bf16_to: Optional[torch.dtype] = None):
        super().__init__()
        self.to = {torch.float32: f32_to}
        if bf16_to is not None:
            self.to[torch.bfloat16] = bf16_to

    def _low(self, t):
        low = self.to.get(t.dtype) if isinstance(t, torch.Tensor) else None
        return None if low is None else t.to(low).to(t.dtype)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view:
            return out
        written = [a for a, spec in zip(args, func._schema.arguments)
                   if spec.alias_info is not None and spec.alias_info.is_write]
        written += [kwargs[s.name] for s in func._schema.arguments
                    if s.name in kwargs and s.alias_info is not None
                    and s.alias_info.is_write]
        if written:
            for t in tree_leaves(written):
                low = self._low(t)
                if low is not None:
                    t.copy_(low)
            return out

        def rnd(t):
            low = self._low(t)
            return t if low is None else low
        return tree_map(rnd, out)
