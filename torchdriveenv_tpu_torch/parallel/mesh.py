"""Data parallelism over ``torch.distributed`` (port of
``torchdriveenv_tpu/parallel/mesh.py``).

The JAX package puts the env batch on a 1-D device mesh and lets GSPMD
insert the gradient all-reduce. Here every rank is one process with one
device, and it owns a contiguous block ``[lo, hi)`` of the global env axis:
the env states, frame stacks and replay ring of its envs. Parameters and
optimizer state are replicated (broadcast from rank 0 once at init).

The invariance rule, which makes a W-rank run equal the one-process run of
the same seed:

  - every rank seeds the carry's generator with the same seed, and every
    draw from it is made at GLOBAL width; the rank keeps its own rows
    (``draw_env_rows``), so no draw has a size that depends on local data;
  - work on env-indexed data is done only on the rows the rank owns;
  - losses and statistics are sums over owned rows divided by the global
    count (``mean_over``), and gradients and statistics are all-reduced as
    sums before they are used (``all_reduce_``).

Every collective is built on ``all_reduce`` and ``broadcast`` only (a gather
is an all-reduce of a zero-filled global-width tensor): those two are what
gloo offers for CUDA tensors, so the same code runs under nccl, under gloo on
the CPU, and under gloo with several ranks sharing one card (nccl refuses
two ranks on one device). One process is ``mesh=None`` (``make_mesh``
returns it for a one-rank group): no collective is issued and every helper
returns its input's one-process value.

Every collective is issued by ``_issue``: under ``utils/spans.py``'s
recording (a profiler session or ``spans.recording()``) it runs inside the
span ``mesh.collective`` and adds to the counters ``mesh.collectives`` (one
a collective) and ``mesh.collective_bytes`` (the tensor's bytes).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from torchdriveenv_tpu_torch.utils import spans


def _issue(op: Callable, t: torch.Tensor, **kwargs) -> None:
    """``op(t, **kwargs)`` (``dist.all_reduce`` or ``dist.broadcast``),
    spanned and counted while spans are recorded."""
    if not spans.enabled():
        op(t, **kwargs)
        return
    spans.count("mesh.collectives", 1)
    spans.count("mesh.collective_bytes", t.numel() * t.element_size())
    with spans.span("mesh.collective"):
        op(t, **kwargs)


def maybe_init_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           timeout_s: Optional[float] = None) -> bool:
    """Join the process group a launcher configured through the
    environment: torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
    ``MASTER_ADDR`` / ``MASTER_PORT``, or, opt-in with ``TDE_DISTRIBUTED=1``,
    a multi-task SLURM job (``SLURM_PROCID`` / ``SLURM_NTASKS`` /
    ``SLURM_LOCALID``, with ``MASTER_ADDR`` and ``MASTER_PORT`` exported by
    the job script). A no-op returning False when none of these is set.

    ``backend``: nccl with a card, gloo on the CPU, unless named.
    ``init_method``: ``env://`` unless named (e.g. ``file://<path>``).
    On the card, ``torch.cuda.set_device(LOCAL_RANK)`` first. Re-entry is
    guarded: returns True when the group is (already) up."""
    if dist.is_initialized():
        return True
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local = int(env.get("LOCAL_RANK", "0"))
    elif (env.get("TDE_DISTRIBUTED", "") == "1"
          and env.get("SLURM_NTASKS", "1") not in ("", "1")):
        rank, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        local = int(env.get("SLURM_LOCALID", "0"))
    else:
        return False
    if (init_method or "env://") == "env://" and "MASTER_ADDR" not in env:
        raise RuntimeError("a distributed launch needs MASTER_ADDR (and "
                           "MASTER_PORT) in the environment")
    cuda = torch.cuda.is_available()
    backend = backend or ("nccl" if cuda else "gloo")
    if cuda:
        torch.cuda.set_device(local)
    kw = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            rank=rank, world_size=world, **kw)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the 1-D env axis: rows ``[lo, hi)`` of the
    ``num_envs`` global envs. Two ranks or more: one process has no mesh."""

    rank: int
    world: int
    num_envs: int

    def __post_init__(self):
        if self.world < 2:
            raise ValueError("one process is mesh=None, not a one-rank Mesh")

    @property
    def local_envs(self) -> int:
        return self.num_envs // self.world

    @property
    def lo(self) -> int:
        return self.rank * self.local_envs

    @property
    def hi(self) -> int:
        return self.lo + self.local_envs


def make_mesh(num_envs: int) -> Optional[Mesh]:
    """The mesh of the running process group; None (one process) when
    there is none or it has one rank. Refuses a ``num_envs`` that the world
    size does not divide (the JAX CLI falls back to replicated there; a
    silent fallback would run W copies of the same envs)."""
    if dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if num_envs % world:
        raise ValueError(f"num_envs={num_envs} does not split over "
                         f"{world} ranks")
    if world == 1:
        return None
    return Mesh(rank=rank, world=world, num_envs=num_envs)


def is_main(mesh: Optional[Mesh]) -> bool:
    """Rank 0, which alone writes logs, checkpoints and videos."""
    return mesh is None or mesh.rank == 0


def env_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's rows of a global-width tensor (the tensor itself in one
    process)."""
    return x if mesh is None else x[mesh.lo:mesh.hi]


def draw_env_rows(draw: Callable[[int], torch.Tensor], local: int,
                  mesh: Optional[Mesh]) -> torch.Tensor:
    """Draw at global width, keep my rows: ``draw(n)`` with ``n`` the
    global env count, sliced to this rank's rows. In one process
    ``draw(local)``."""
    return env_rows(draw(local if mesh is None else mesh.num_envs), mesh)


def all_reduce_(tensors: Sequence[torch.Tensor], mesh: Optional[Mesh]
                ) -> Sequence[torch.Tensor]:
    """Sum ``tensors`` over the ranks, in place, in one collective (they
    are packed into one flat buffer per dtype). No collective in one
    process."""
    if mesh is None or not tensors:
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        _issue(dist.all_reduce, flat)
        for t, f in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(f.view_as(t))
    return tensors


def mean_over(x: torch.Tensor, count: int, mesh: Optional[Mesh]
              ) -> torch.Tensor:
    """The mean over a global batch of ``count`` rows of which this rank
    holds ``x``: ``x.mean()`` in one process; else this rank's share,
    ``x.sum() / count``, which ``all_reduce_`` (of the value, or of the
    gradients it yields) completes."""
    return x.mean() if mesh is None else x.sum() / count


def global_mean(x: torch.Tensor, count: int, mesh: Optional[Mesh]
                ) -> torch.Tensor:
    """The mean over the global batch of ``count`` rows, on every rank."""
    if mesh is None:
        return x.mean()
    s = x.sum().reshape(1)
    all_reduce_([s], mesh)
    return s[0] / count


def gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The global-width tensor of which every rank holds its rows ``x``, on
    every rank (a collective): an all-reduce of a zero-filled tensor."""
    if mesh is None:
        return x
    dtype = torch.uint8 if x.dtype == torch.bool else x.dtype
    full = torch.zeros((mesh.num_envs,) + tuple(x.shape[1:]), dtype=dtype,
                       device=x.device)
    full[mesh.lo:mesh.hi] = x
    _issue(dist.all_reduce, full)
    return full.to(x.dtype)


def offset_of(count: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The sum of ``count`` (a 0-d integer tensor) over the lower ranks:
    where this rank's share starts in global rank order. 0 in one
    process."""
    if mesh is None:
        return torch.zeros_like(count)
    counts = torch.zeros(mesh.world, dtype=torch.int64, device=count.device)
    counts[mesh.rank] = count
    _issue(dist.all_reduce, counts)
    return counts[:mesh.rank].sum().to(count.dtype)


def agree(flag: bool, mesh: Optional[Mesh]) -> bool:
    """Rank 0's ``flag`` on every rank (a host decision, such as a wall-
    clock stop, that all ranks must take together)."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int64, device=_device())
    _issue(dist.broadcast, t, src=0)
    return bool(t.item())


def _device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def _tensors_of(state: Any) -> List[torch.Tensor]:
    """Every tensor of an agent state: the parameters and buffers of its
    modules, and its tensor fields."""
    out: List[torch.Tensor] = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.nn.Module):
            out += list(v.parameters()) + list(v.buffers())
        elif isinstance(v, torch.Tensor):
            out.append(v)
    return out


@torch.no_grad()
def replicate_(state: Any, mesh: Optional[Mesh]) -> Any:
    """Broadcast an agent state's tensors (a dataclass of modules and
    tensors, as ``agent.state``) from rank 0, in place."""
    if mesh is not None:
        for t in _tensors_of(state):
            _issue(dist.broadcast, t.data, src=0)
    return state


def map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    """``fn`` over the tensor leaves of dataclasses, dicts, lists, tuples
    and named tuples; other leaves are kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_tensors(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tensors(fn, v) for v in tree)
    return tree


def shard_carry(carry: Any, mesh: Optional[Mesh]) -> Any:
    """This rank's part of a global carry (or of a reset's draws): every
    tensor leaf whose leading axis is the global env batch keeps rows
    ``[lo, hi)`` (copied, so the global tensor can be freed); every other
    leaf (scalars, the buffer's ``pos`` / ``filled``, modules) is kept as it
    is. Hand it only the env-indexed parts of a tree: a parameter whose
    first axis happens to equal ``num_envs`` would be cut too."""
    if mesh is None:
        return carry

    def place(x):
        if x.dim() >= 1 and x.shape[0] == mesh.num_envs:
            return x[mesh.lo:mesh.hi].clone()
        return x

    return map_tensors(place, carry)


def fetch_to_host(tree: Any, mesh: Optional[Mesh]) -> Any:
    """A tree of this rank's env rows -> the global tree on the host. Every
    tensor leaf whose leading axis is this rank's env count is gathered
    (a collective per leaf: call it on every rank, in the same order, then
    let rank 0 alone write), then copied to the CPU leaf by leaf, so the
    device holds one global leaf at a time."""
    if mesh is None:
        return map_tensors(lambda x: x.detach().cpu(), tree)

    def fetch(x):
        if x.dim() >= 1 and x.shape[0] == mesh.local_envs:
            x = gather_rows(x, mesh)
        return x.detach().cpu()

    return map_tensors(fetch, tree)
