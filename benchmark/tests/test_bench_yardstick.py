"""The yardstick's frozen copies held equal to the port's functions they
were copied from, on small seeded inputs on the CPU. (The test imports the
port; the harness's timed path reads only the copies.)"""

import pytest
import torch

from benchmark.metrics import _costs, _trace
from benchmark.reference import arrays as rarrays
from benchmark.reference import config as rconfig
from benchmark.reference import policy_net as rpolicy

from torchdriveenv_tpu_torch import bench
from torchdriveenv_tpu_torch.config import construct_env_config
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import load_assets
from torchdriveenv_tpu_torch.npc.policy_net import default_params
from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc


@pytest.fixture(scope="module")
def both():
    return (load_assets("train", device="cpu"),
            rarrays.load_assets("train", device="cpu"))


@pytest.mark.parametrize("mode", ["route", "policy"])
def test_phase_costs_equal_the_ports(both, mode):
    passets, rassets = both
    raw = {"npc_mode": mode, "reset_pool": 4}
    pcfg, rcfg = construct_env_config(raw), rconfig.env_config(raw)
    reset_fn, step_fn = make_env_fns(pcfg, passets)
    g = torch.Generator().manual_seed(17)
    state, _ = reset_fn(g, 12)
    for _ in range(3):
        state = step_fn(state, torch.rand((12, 2), generator=g) - 0.5, g).state
    pnpc = default_params("cpu") if mode == "policy" else None
    rnpc = (rpolicy.load_npc_policy(rpolicy.NPC_POLICY, "cpu")
            if mode == "policy" else None)
    pprep = bench.render_inputs(pcfg, passets, state)
    rprep = _costs.render_inputs(rcfg, rassets, state)
    for a, b in zip(pprep, rprep):
        assert torch.equal(a, b)
    pc = bench.phase_costs(pcfg, passets, state, pprep, pnpc)
    c = _costs.phase_costs(rcfg, rassets, state, rprep, rnpc)
    assert c == pc
    assert (_costs.physics_cost(rcfg, rassets, state, rnpc)
            == bench.physics_cost(pcfg, passets, state, pnpc))
    assert (_costs.autoreset_cost(rcfg, rassets, state)
            == bench.autoreset_cost(pcfg, passets, state))
    assert (_costs.render_cost(rassets.maps, state.town, *rprep)
            == rc.render_cost(passets.maps, state.town, *pprep))
    for per_step_s, share in ((0.0123, 0.02), (0.5, 0.0)):
        assert (_costs.roofline(c, per_step_s, share)
                == bench.roofline(pc, per_step_s, share))
    for cost in c.values():
        assert _costs.least_s(cost) == bench.least_s(cost)


def test_busy_union_equals_the_ports(monkeypatch):
    g = torch.Generator().manual_seed(3)
    kernels = []
    for i in range(200):
        ts = float(torch.randint(0, 100000, (1,), generator=g))
        dur = float(torch.randint(1, 900, (1,), generator=g))
        kernels.append({"cat": "kernel", "name": f"k{i % 7}", "ts": ts,
                        "dur": dur})
    window_s = 0.2
    monkeypatch.setattr(bench, "traced_kernels",
                        lambda fn, path: (window_s, kernels))
    ported = bench.profile_steps(None, None, None, None, 4, "unused")
    assert _trace.busy_us(kernels) * 1e-6 == pytest.approx(
        ported["device_busy_s"], rel=0, abs=1e-12)
    names = [n for n, _ in _trace.top_ops(kernels)]
    assert names == [n for n, _, _ in ported["top_kernels_ms_per_step"]]


def test_idle_gaps_name_the_launching_host_op():
    events = [
        {"cat": "cpu_op", "name": "aten::add", "ts": 0.0, "dur": 5.0},
        {"cat": "cpu_op", "name": "aten::mul", "ts": 50.0, "dur": 5.0},
        {"cat": "cpu_op", "name": "outer", "ts": 40.0, "dur": 30.0},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 1.0,
         "dur": 1.0, "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 51.0,
         "dur": 1.0, "args": {"correlation": 2}},
        {"cat": "kernel", "name": "k_add", "ts": 3.0, "dur": 4.0,
         "args": {"correlation": 1}},
        {"cat": "kernel", "name": "k_mul", "ts": 53.0, "dur": 4.0,
         "args": {"correlation": 2}},
    ]
    s = _trace.summarize(1e-4, events)
    assert s["busy_s"] == pytest.approx(8e-6)
    assert s["breakdown"]["idle_gaps"] == [["before aten::mul",
                                            pytest.approx(46e-6)]]
    assert [n for n, _ in s["breakdown"]["device_ops"]] == ["k_add", "k_mul"]


def test_torso_flops_count_what_a_forward_runs():
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.metrics import _learner
    from benchmark.reference.cnn import NatureCNN

    net = NatureCNN(9, 512, 64, compute_dtype=torch.float32)
    shapes = {f"t.{k}": tuple(v.shape) for k, v in net.state_dict().items()}
    flops, first = _learner.torso_flops(shapes, "t.", 64)
    with FlopCounterMode(display=False) as fc:
        net(torch.zeros(3, 9, 64, 64, dtype=torch.uint8))
    assert 3 * flops == fc.get_total_flops()
    assert first == 2 * 15 * 15 * 32 * 9 * 8 * 8


def test_lower_precision_rounds_results_and_writes():
    from benchmark.reference.lowp import LowerPrecision

    x = torch.tensor([1.0 + 2 ** -12, 3.0])
    y = torch.tensor([2 ** -12, 0.0])
    with LowerPrecision(torch.bfloat16):
        s = x + y                       # 1 + 2^-11 rounds to 1 in bf16
        v = x[:1]                       # a view: left alone
        z = x.clone()
        z.add_(y)                       # written in place, then rounded
    assert s.tolist() == [1.0, 3.0]
    assert v.data_ptr() == x.data_ptr() and x[0] == 1.0 + 2 ** -12
    assert z.tolist() == [1.0, 3.0]
