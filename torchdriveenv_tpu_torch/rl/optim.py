"""What the learners share around ``torch.optim.Adam``: carrying its state
in and out as plain containers, applying gradients taken with
``torch.autograd.grad``, and optax's global-norm clip.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping, Sequence, Tuple

import torch

Named = Iterable[Tuple[str, torch.Tensor]]


def adam_export(opt: torch.optim.Adam, named: Named) -> Dict[str, Any]:
    """``torch.optim.Adam`` state -> ``{"step", "exp_avg", "exp_avg_sq"}``
    keyed like a state dict (see ``models/convert.py``)."""
    out = {"step": 0, "exp_avg": {}, "exp_avg_sq": {}}
    for name, p in named:
        s = opt.state.get(p)
        out["exp_avg"][name] = (s["exp_avg"].detach().clone() if s
                                else torch.zeros_like(p))
        out["exp_avg_sq"][name] = (s["exp_avg_sq"].detach().clone() if s
                                   else torch.zeros_like(p))
        if s:
            out["step"] = int(s["step"])
    return out


def adam_load(opt: torch.optim.Adam, named: Named,
              adam: Mapping[str, Any]) -> None:
    """Inverse of ``adam_export``, into the live optimizer. The step count
    goes where this optimizer keeps it: beside the parameter when it is
    capturable or fused, on the CPU otherwise."""
    group = opt.param_groups[0]
    on_device = bool(group.get("capturable") or group.get("fused"))
    for name, p in named:
        opt.state[p] = {
            "step": torch.tensor(float(adam["step"]), dtype=torch.float32,
                                 device=p.device if on_device else "cpu"),
            "exp_avg": adam["exp_avg"][name].to(p.device, p.dtype).clone(),
            "exp_avg_sq": adam["exp_avg_sq"][name].to(p.device, p.dtype).clone(),
        }


def apply_grads(opt: torch.optim.Adam, params: Sequence[torch.Tensor],
                grads: Sequence[torch.Tensor]) -> None:
    """One optimizer step on gradients that are already in hand; nothing is
    left on any ``.grad``."""
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    opt.zero_grad(set_to_none=True)


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float
                         ) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: gradients whose global
    norm is under ``max_norm`` stay as they are, otherwise each becomes
    ``g / norm * max_norm``. (``torch.nn.utils.clip_grad_norm_`` scales by
    ``max_norm / (norm + 1e-6)`` instead.) Returns the norm; no host read."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    under = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(under, one, norm))
    torch._foreach_mul_(grads, torch.where(under, one, one * max_norm))
    return norm
