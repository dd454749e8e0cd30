"""The port's spans and counters (``utils/spans.py``) on the CPU, at 8 envs:
off they record nothing and cost one shared null context; on (inside
``spans.recording()`` or a ``torch.profiler`` session) they leave the env
step's outputs and operations as they were, nest as the layers do, and the
``envs_reset`` counter counts the done envs.

This module imports nothing of JAX. Its ``cuda`` case runs on the card,
from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_spans.py -m cuda
"""

import collections
import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import batched
from torchdriveenv_tpu_torch.maps.arrays import load_assets
from torchdriveenv_tpu_torch.parallel.train_step import make_offpolicy_train_fns
from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig
from torchdriveenv_tpu_torch.utils import spans

torch.set_num_threads(2)
B, STEPS = 8, 4
ENV_SPANS = ("env.step", "env.core", "env.npc", "env.autoreset",
             "env.render", "env.render_inputs")
# each env span's innermost enclosing span (None: a root)
PARENT = {"env.step": None, "env.core": "env.step", "env.npc": "env.core",
          "env.autoreset": "env.step", "env.render": "env.step",
          "env.render_inputs": "env.render"}
NPC = ("route", "policy")
RESET = {"pooled": 4, "exact": 0}


@pytest.fixture(scope="module")
def assets():
    return load_assets("val", device="cpu")


@pytest.fixture(autouse=True)
def empty_log():
    spans.clear()
    yield
    spans.clear()


def _cfg(npc="route", reset="pooled"):
    # episodes of 3 steps: every env is done at the third
    return EnvConfig(npc_mode=npc, reset_pool=RESET[reset],
                     max_environment_steps=3)


def _rollout(assets, cfg, with_final_obs=False, steps=STEPS, around=None):
    """The steps after a reset, inside the context manager ``around``."""
    reset_fn, step_fn = batched.make_env_fns(cfg, assets,
                                             with_final_obs=with_final_obs)
    g = torch.Generator().manual_seed(0)
    state, _ = reset_fn(g, B)
    actions = torch.tensor([[0.4, 0.05]]).repeat(B, 1)
    outs = []
    with around or contextlib.nullcontext():
        for _ in range(steps):
            outs.append(step_fn(state, actions, g))
            state = outs[-1].state
    return outs


def _tensors(out):
    """Every tensor of a step's output, by name."""
    d = {f"state.{f.name}": getattr(out.state, f.name)
         for f in dataclasses.fields(out.state)
         if getattr(out.state, f.name) is not None}
    d.update({k: v for k, v in out._asdict().items()
              if isinstance(v, torch.Tensor)})
    d.update({f"info.{k}": v for k, v in out.info.items()})
    return d


def _trace(tmp_path, fn):
    """The trace's events of ``fn(prof)`` that enters the profiler ``prof``."""
    prof = profile(activities=[ProfilerActivity.CPU])
    fn(prof)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _forced_off(monkeypatch):
    monkeypatch.setattr(spans, "span", lambda name: spans._NULL)
    monkeypatch.setattr(spans, "count", lambda name, tensor: None)


def test_off_returns_the_shared_null_and_logs_nothing(assets):
    assert not torch.autograd.profiler._is_profiler_enabled
    assert spans.span("env.step") is spans.span("train.step")
    with spans.span("env.step"):
        spans.count("envs_reset", torch.ones(3, dtype=torch.bool))
    _rollout(assets, _cfg(), steps=1)
    assert spans.records() == [] and spans.counters() == {}
    assert spans.dropped() == 0


@pytest.mark.parametrize("with_final_obs", [False, True],
                         ids=["obs", "final_obs"])
@pytest.mark.parametrize("reset", list(RESET))
@pytest.mark.parametrize("npc", NPC)
def test_step_outputs_are_bit_equal_on_and_off(assets, npc, reset,
                                               with_final_obs):
    cfg = _cfg(npc, reset)
    off = _rollout(assets, cfg, with_final_obs)
    on = _rollout(assets, cfg, with_final_obs, around=spans.recording())
    assert sum(r["name"] == "env.step" for r in spans.records()) == STEPS
    for a, b in zip(off, on):
        ta, tb = _tensors(a), _tensors(b)
        assert ta.keys() == tb.keys()
        for k in ta:
            assert torch.equal(ta[k], tb[k]), k


@pytest.mark.parametrize("npc", NPC)
def test_profiler_trace_nests_the_env_spans(assets, tmp_path, npc):
    """Under a profiler alone the spans are on: every env span is a
    ``user_annotation`` of the trace whose innermost enclosing annotation
    is its parent of the layers' table."""
    events = _trace(tmp_path, lambda prof: _rollout(assets, _cfg(npc),
                                                    steps=1, around=prof))
    notes = [e for e in events if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in notes} == set(ENV_SPANS)
    for e in notes:
        outer = [o for o in notes if o is not e and o["ts"] <= e["ts"]
                 and e["ts"] + e["dur"] <= o["ts"] + o["dur"]]
        inner = min(outer, key=lambda o: o["dur"])["name"] if outer else None
        assert inner == PARENT[e["name"]], e["name"]
    assert {r["name"] for r in spans.records()} == set(ENV_SPANS)


@pytest.mark.parametrize("with_final_obs", [False, True],
                         ids=["obs", "final_obs"])
@pytest.mark.parametrize("npc", NPC)
def test_spans_add_no_operation(assets, tmp_path, monkeypatch, npc,
                                with_final_obs):
    def ops(events):
        return collections.Counter(e["name"] for e in events
                                   if e.get("cat") == "cpu_op")

    def rollout(prof):
        _rollout(assets, _cfg(npc), with_final_obs, around=prof)

    on = ops(_trace(tmp_path, rollout))
    _forced_off(monkeypatch)
    off = ops(_trace(tmp_path, rollout))
    assert on == off and sum(on.values()) > 1000


@pytest.mark.parametrize("with_final_obs", [False, True],
                         ids=["obs", "final_obs"])
def test_parents_roots_and_self_time(assets, with_final_obs):
    _rollout(assets, _cfg(), with_final_obs, steps=2,
             around=spans.recording())
    recs = spans.records()
    roots = [i for i, r in enumerate(recs) if r["name"] == "env.step"]
    assert len(roots) == 2
    for i, r in enumerate(recs):
        want = PARENT[r["name"]]
        if want is None:
            assert r["parent"] == -1 and r["root"] == i
        else:
            assert recs[r["parent"]]["name"] == want
            assert r["root"] == max(j for j in roots if j < i)
        kids = [k for k in recs if k["parent"] == i]
        # children on one host thread run one after another
        assert r["self_host_ms"] == pytest.approx(
            r["host_ms"] - sum(k["host_ms"] for k in kids), abs=1e-9)
        assert 0 <= r["self_host_ms"] <= r["host_ms"]
        assert r["stream_ms"] is None and r["self_stream_ms"] is None
    renders = sum(r["name"] == "env.render" for r in recs)
    assert renders == (4 if with_final_obs else 2)


def test_self_time_takes_the_union_of_the_children():
    assert spans._union_ms([(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)],
                           0.0, 10.0) == 4.0
    assert spans._union_ms([(-1.0, 2.0), (9.0, 12.0)], 0.0, 10.0) == 3.0
    assert spans._union_ms([], 0.0, 10.0) == 0.0


@pytest.mark.parametrize("with_final_obs", [False, True],
                         ids=["obs", "final_obs"])
@pytest.mark.parametrize("reset", list(RESET))
def test_envs_reset_counts_the_done_envs(assets, reset, with_final_obs):
    outs = _rollout(assets, _cfg(reset=reset), with_final_obs,
                    around=spans.recording())
    done = sum(int((o.terminated | o.truncated).sum()) for o in outs)
    assert done >= B            # the third step ends every episode
    assert spans.counters() == {"envs_reset": done}
    assert spans.counters() == {"envs_reset": done}   # read, not cleared
    spans.clear()
    assert spans.counters() == {} and spans.records() == []


def test_sac_train_step_logs_its_phases(assets):
    spi, upi = 2, 3
    agent = SAC(SACConfig(batch_size=16, learning_starts=0),
                compute_dtype=torch.float32)
    init_fn, train_step = make_offpolicy_train_fns(
        EnvConfig(), agent, B, buffer_capacity=64, steps_per_iter=spi,
        updates_per_iter=upi, device="cpu")
    carry = init_fn(assets, seed=0)
    with spans.recording():
        for _ in range(2):
            carry, _ = train_step(assets, carry)
    recs = spans.records()
    names = collections.Counter(r["name"] for r in recs)
    assert names["train.step"] == 2 and names["train.env"] == 2
    assert names["train.sample"] == names["train.update"] == 2 * upi
    assert names["env.step"] == 2 * spi
    for i, r in enumerate(recs):
        if r["name"] == "train.step":
            assert r["parent"] == -1 and r["root"] == i
            continue
        assert recs[r["root"]]["name"] == "train.step"
        if r["name"] in ("train.env", "train.sample", "train.update"):
            assert recs[r["parent"]]["name"] == "train.step"
        if r["name"] == "env.step":
            assert recs[r["parent"]]["name"] == "train.env"


def test_the_log_drops_and_counts_past_its_bound(monkeypatch):
    monkeypatch.setattr(spans, "MAX_RECORDS", 3)
    flag = torch.ones(2, dtype=torch.bool)
    with spans.recording():
        for _ in range(2):
            with spans.span("outer"):
                with spans.span("inner"):
                    spans.count("n", flag)
        for _ in range(3):
            spans.count("n", flag)
    recs = spans.records()
    assert [r["name"] for r in recs] == ["outer", "inner", "outer"]
    assert recs[2]["parent"] == -1 and recs[2]["root"] == 2
    assert spans.counters() == {"n": 6}
    assert spans.dropped() == 1 + 2
    spans.clear()
    assert spans.dropped() == 0


def test_the_profiler_flag_is_there():
    """The spans follow ``torch.autograd.profiler._is_profiler_enabled``: a
    torch without it would leave them off under every profiler, so its
    absence must raise."""
    flag = torch.autograd.profiler._is_profiler_enabled
    assert flag is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
        assert spans.span("x") is not spans._NULL
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_a_missing_profiler_flag_raises(monkeypatch):
    monkeypatch.delattr(torch.autograd.profiler, "_is_profiler_enabled")
    with pytest.raises(AttributeError):
        spans.span("x")


@pytest.mark.cuda
def test_stream_times_and_kernels_on_the_card(monkeypatch):
    """On the card every span has stream times, the children lie inside
    their parent on the device's timeline, and the kernels of traced steps
    are the same, in number and name, with the spans on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: stream times come from CUDA events")
    assets = load_assets("val", device="cuda")
    reset_fn, step_fn = batched.make_env_fns(_cfg(), assets)
    g = torch.Generator(device="cuda").manual_seed(0)
    state0, _ = reset_fn(g, 64)
    actions = torch.tensor([[0.4, 0.05]], device="cuda").repeat(64, 1)

    def steps():
        state = state0
        for _ in range(STEPS):
            state = step_fn(state, actions, g).state
        torch.cuda.synchronize()

    def kernels():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps()
        return collections.Counter(
            e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(tuple(ENV_SPANS)))

    steps()
    spans.clear()
    on = kernels()
    recs = spans.records()
    assert sum(r["name"] == "env.step" for r in recs) == STEPS
    for r in recs:
        assert r["stream_ms"] is not None and r["stream_ms"] >= 0
        assert 0 <= r["self_stream_ms"] <= r["stream_ms"] + 1e-3
        if r["parent"] >= 0:
            p = recs[r["parent"]]
            assert p["stream_start_ms"] <= r["stream_start_ms"] + 1e-3
            assert r["stream_end_ms"] <= p["stream_end_ms"] + 1e-3
    with monkeypatch.context() as m:
        _forced_off(m)
        off = kernels()
    assert on == off and sum(on.values()) > 0
