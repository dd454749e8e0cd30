"""The nine readers of the program's spans and counter (``metrics/_spans.py``)
on synthetic logs, their arithmetic worked by hand: stream durations, self
time less the union of the children, the per-step normalisation. Each
reads ``None`` where its span or counter is absent, where a span has no
stream times, and where the program has no span module."""

import sys

import pytest

from benchmark import manifest
from benchmark.metrics import _spans

ENV = ("npc_ms", "physics_ms", "autoreset_ms", "render_ms",
       "render_inputs_ms", "envs_reset_per_step")
TRAIN = ("train_env_ms", "sample_ms", "learner_update_ms.span")


def _log(*spans):
    """Records from (name, parent name or None, stream start, end), each
    parent the latest span of that name before it."""
    recs = []
    for name, parent, a, b in spans:
        p = max((i for i, r in enumerate(recs) if r["name"] == parent),
                default=-1)
        recs.append({"name": name, "parent": p,
                     "root": recs[p]["root"] if p >= 0 else len(recs),
                     "stream_start_ms": a, "stream_end_ms": b})
    return recs


# two env steps of 20 and 22 ms; the second's env.core holds two children
# that overlap ([21, 25] and [24, 27]: 6 ms of union)
ENV_LOG = _log(
    ("env.step", None, 0.0, 20.0),
    ("env.core", "env.step", 0.0, 8.0),
    ("env.npc", "env.core", 1.0, 4.0),
    ("env.autoreset", "env.step", 8.0, 11.0),
    ("env.render", "env.step", 11.0, 19.0),
    ("env.render_inputs", "env.render", 11.0, 13.0),
    ("env.step", None, 20.0, 42.0),
    ("env.core", "env.step", 20.0, 30.0),
    ("env.npc", "env.core", 21.0, 25.0),
    ("other", "env.core", 24.0, 27.0),
    ("env.autoreset", "env.step", 30.0, 35.0),
    ("env.render", "env.step", 35.0, 41.0),
    ("env.render_inputs", "env.render", 35.0, 36.5),
)
ENV_WANT = {
    "npc_ms": (3.0 + 4.0) / 2,
    "physics_ms": ((8.0 - 3.0) + (10.0 - 6.0)) / 2,
    "autoreset_ms": (3.0 + 5.0) / 2,
    "render_ms": (8.0 + 6.0) / 2,
    "render_inputs_ms": (2.0 + 1.5) / 2,
    "envs_reset_per_step": 81 / 2,
}
# one train step: its env part, then two (sample, update) pairs
TRAIN_LOG = _log(
    ("train.step", None, 0.0, 100.0),
    ("train.env", "train.step", 0.0, 40.0),
    ("env.step", "train.env", 1.0, 20.0),
    ("env.step", "train.env", 20.0, 39.0),
    ("train.sample", "train.step", 40.0, 42.0),
    ("train.update", "train.step", 42.0, 60.0),
    ("train.sample", "train.step", 60.0, 63.0),
    ("train.update", "train.step", 63.0, 99.0),
)
TRAIN_WANT = {"train_env_ms": 40.0, "sample_ms": (2.0 + 3.0) / 2,
              "learner_update_ms.span": (18.0 + 36.0) / 2}


def _reading(monkeypatch, name, recs, counters=None):
    monkeypatch.setattr(_spans, "log", lambda: (recs, counters or {}))
    return manifest.metric_reader(name).read({})


@pytest.mark.parametrize("name", ENV + TRAIN)
def test_reader_on_a_synthetic_log(monkeypatch, name):
    want = {**ENV_WANT, **TRAIN_WANT}[name]
    recs = ENV_LOG if name in ENV else TRAIN_LOG
    got = _reading(monkeypatch, name, recs, {"envs_reset": 81})
    assert got == pytest.approx(want, abs=1e-12)
    m = manifest.load_manifest()
    spec = next(x for x in m["per_layer"] if x["name"] == name)
    assert manifest.metric_reader(name).MOVES == spec["moves"]
    assert spec["workloads"] == (
        ["env_main.idm_explore", "env_main.gru_explore"] if name in ENV
        else ["sac_stage1.steady"])


@pytest.mark.parametrize("name", ENV + TRAIN)
def test_reader_reads_none_without_its_span(monkeypatch, name):
    other = TRAIN_LOG if name in ENV else ENV_LOG
    assert _reading(monkeypatch, name, other) is None
    assert _reading(monkeypatch, name, []) is None


@pytest.mark.parametrize("name", ENV + TRAIN)
def test_reader_reads_none_without_stream_times(monkeypatch, name):
    recs = ENV_LOG if name in ENV else TRAIN_LOG
    host_only = [{**r, "stream_start_ms": None, "stream_end_ms": None}
                 for r in recs]
    counters = {"envs_reset": 81}
    got = _reading(monkeypatch, name, host_only, counters)
    if name == "envs_reset_per_step":       # a count needs no clock
        assert got == ENV_WANT[name]
    else:
        assert got is None


def test_a_counter_needs_its_steps(monkeypatch):
    assert _reading(monkeypatch, "envs_reset_per_step", ENV_LOG) is None
    assert _reading(monkeypatch, "envs_reset_per_step", TRAIN_LOG[:1],
                    {"envs_reset": 5}) is None
    assert _reading(monkeypatch, "envs_reset_per_step", ENV_LOG,
                    {"envs_reset": 0}) == 0.0


@pytest.mark.parametrize("name", ENV + TRAIN)
def test_no_span_module_reads_none(monkeypatch, name):
    # a program without ``utils/spans.py``: the import fails
    import torchdriveenv_tpu_torch.utils as utils
    monkeypatch.setitem(sys.modules, "torchdriveenv_tpu_torch.utils.spans",
                        None)
    monkeypatch.delattr(utils, "spans", raising=False)
    assert _spans.log() is None
    assert manifest.metric_reader(name).read({}) is None


def test_an_empty_program_log_reads_none():
    from torchdriveenv_tpu_torch.utils import spans
    spans.clear()
    assert _spans.log() == ([], {})
    for name in ENV + TRAIN:
        assert manifest.metric_reader(name).read({}) is None


def test_union_by_hand():
    assert _spans.union_ms([(1.0, 3.0), (2.0, 4.0), (6.0, 7.0)],
                           0.0, 10.0) == 4.0
    assert _spans.union_ms([(-2.0, 1.0), (9.0, 11.0)], 0.0, 10.0) == 2.0
    assert _spans.union_ms([(3.0, 5.0), (3.5, 4.0)], 0.0, 10.0) == 2.0
    assert _spans.union_ms([], 0.0, 10.0) == 0.0
