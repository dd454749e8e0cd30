"""The traffic generator on the CPU: each mix's action kind found by name,
the draws fixed by the seed, and a replay ring's history filled alike in
the program's ring and the reference's."""

import os
import sys
import types

import pytest
import torch

from benchmark import gen, manifest


def _mixes():
    tdir = os.path.join(manifest.BENCH_DIR, "traffic")
    return sorted(f[:-5] for f in os.listdir(tdir) if f.endswith(".json"))


@pytest.mark.parametrize("mix", _mixes())
def test_every_mix_finds_its_action_kind(mix):
    spec = manifest.traffic(mix)["actions"]
    kind = gen.action_kind(spec["kind"])
    assert callable(kind.make)
    src = gen.action_source(spec, num_envs=5, seed=2 ** 31 + 7,
                            device="cpu")
    if src is None:
        return
    a, b = src(None, 0), src(None, 1)
    assert a.shape == (5, 2) and a.dtype == torch.float32
    assert not torch.equal(a, b)
    again = gen.action_source(spec, num_envs=5, seed=2 ** 31 + 7,
                              device="cpu")
    assert torch.equal(again(None, 1), b)
    low, high = torch.tensor(spec["low"]), torch.tensor(spec["high"])
    assert bool(((a >= low) & (a <= high)).all())


def test_a_new_kind_is_found_by_its_name(monkeypatch):
    mod = types.ModuleType("benchmark.actions.held")
    mod.make = lambda spec, **kw: (lambda state, k: torch.full(
        (kw["num_envs"], 2), float(spec["value"])))
    monkeypatch.setitem(sys.modules, "benchmark.actions.held", mod)
    src = gen.action_source({"kind": "held", "value": 0.25}, num_envs=3,
                            seed=1, device="cpu")
    assert torch.equal(src(None, 9), torch.full((3, 2), 0.25))


def test_ring_filled_alike_in_the_program_and_the_reference():
    from benchmark.reference import buffer as rbuffer
    from torchdriveenv_tpu_torch.rl import buffer as pbuffer

    e, n, cells, seed = 3, 40, 27, 2 ** 31 + 11
    p = gen.fill_ring(pbuffer.create(e, n, (3, 4, 4), device="cpu"), cells,
                      seed, "cpu")
    r = gen.fill_ring(rbuffer.create(e, n, (3, 4, 4), device="cpu"), cells,
                      seed, "cpu")
    for f in ("frames", "action", "reward", "done", "terminal", "ep_start",
              "term_frames", "term_slot", "term_ptr", "is_demo", "pos",
              "filled", "cur_ep_start"):
        assert torch.equal(getattr(p, f), getattr(r, f)), f
    assert int(p.pos) == int(p.filled) == cells
    assert bool(p.done[:, cells - 1].all()) and not bool(p.done[:, cells:]
                                                         .any())
    assert bool(p.is_demo[:, :cells].all())
    # each cell's episode starts after the last done cell before it
    for env in range(e):
        start = 0
        for t in range(cells):
            assert int(p.ep_start[env, t]) == start
            if bool(p.done[env, t]):
                start = t + 1
    # the side ring's pointer counts the truncated cells
    trunc = p.done & ~p.terminal
    assert torch.equal(p.term_ptr, trunc.sum(dim=1).to(torch.int32))
    # both sample the same batch from the same draws
    gp = torch.Generator().manual_seed(5)
    gr = torch.Generator().manual_seed(5)
    bp = pbuffer.sample(p, 16, 3, generator=gp)
    br = rbuffer.sample(r, 16, 3, generator=gr)
    for k in br:
        assert torch.equal(bp[k], br[k]), k
