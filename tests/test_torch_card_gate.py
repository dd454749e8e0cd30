"""The comparators that decide ``chip_smoke.py``'s verdicts on the card,
held on the CPU to the rules their docstrings state. A slip in one of them
would pass a broken port on the card, where no other test looks.

  adam_close       the CPU tests' Adam-parity tolerance over two agent
                   trees: atol 2e-5 plus 1e-5 of the largest magnitude,
                   at most max(4, 1e-5 n) elements over it, none by more
                   than 100 times; integer leaves exact.
  carry_close      two ``full_latest`` trees: the agents as above, the step
                   count and the generator exact, env rows' floats at
                   atol 1e-4 / rtol 1e-5, uint8 frames at most a 1e-3 share
                   apart, other integers exact.
  _compare_rows    sharded rollout rows against one process's: flags and
                   ints exact, agent states at atol 1e-4 / rtol 1e-5,
                   frames at most a 1e-3 share of pixels apart.
  _metrics_close   the same metric names, each within METRIC_TOL.
  host_launches    a new step function launches the rasterizer from the
                   host in its first two calls (eager, capture), never in a
                   replay.

Each case fails if the rule it names were dropped from the comparator.
"""

import importlib
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
try:
    cs = importlib.import_module("chip_smoke")
finally:
    sys.path.remove(ROOT)

# the tolerance adam_close gives a leaf of ones: atol + rtol x 1
TOL = cs.ADAM_ATOL + cs.ADAM_SCALE_RTOL


def _agent():
    return {"net": {"w": torch.ones(100), "b": torch.ones(10)},
            "opt": {"step": torch.tensor(3), "count": 7}}


def _off(tree, leaf, idx, by):
    """A copy of ``tree`` with ``tree["net"][leaf][idx]`` moved by ``by``."""
    out = {"net": {k: v.clone() for k, v in tree["net"].items()},
           "opt": dict(tree["opt"])}
    out["net"][leaf][idx] += by
    return out


def _adam_case(name):
    want = _agent()
    if name == "equal trees":
        return want, _agent(), dict(ok=True, bit_equal=True)
    if name == "one element over 100x its tolerance":
        return want, _off(want, "b", [0], 101 * TOL), dict(
            ok=False, bit_equal=False, elements_over_tol=1)
    if name == "four elements over, each under 100x":
        return want, _off(want, "w", [0, 1, 2, 3], 2 * TOL), dict(
            ok=True, bit_equal=False, elements_over_tol=4)
    if name == "five elements over, each under 100x":
        return want, _off(want, "w", [0, 1, 2, 3, 4], 2 * TOL), dict(
            ok=False, bit_equal=False, elements_over_tol=5)
    got = _agent()
    if name == "an integer tensor leaf differs":
        got["opt"]["step"] = torch.tensor(4)
    else:                                   # a Python integer leaf differs
        got["opt"]["count"] = 8
    return want, got, dict(ok=False, bit_equal=False)


@pytest.mark.parametrize("name", [
    "equal trees", "one element over 100x its tolerance",
    "four elements over, each under 100x",
    "five elements over, each under 100x",
    "an integer tensor leaf differs", "a Python integer leaf differs"])
def test_adam_close(name):
    want, got, expect = _adam_case(name)
    res = cs.adam_close(got, want)
    assert {k: res[k] for k in expect} == expect


def _carry():
    return {"agent": _agent(), "env_steps": 4096,
            "generator": torch.arange(16, dtype=torch.uint8),
            "env_state": {"agent_states": torch.ones(8, 4, 3),
                          "step_idx": torch.arange(8, dtype=torch.int32)},
            "obs_stack": torch.zeros(8, 9, 16, 16, dtype=torch.uint8)}


def _carry_case(name):
    want, got = _carry(), _carry()
    if name == "equal trees":
        return want, got, dict(ok=True, bit_equal=True)
    if name == "the generator state differs":
        got["generator"][5] += 1
        return want, got, dict(ok=False, bit_equal=False,
                               same_step_and_generator=False, envs_ok=True)
    if name == "the step count differs":
        got["env_steps"] += 128
        return want, got, dict(ok=False, same_step_and_generator=False)
    n = got["obs_stack"].numel()
    if name == "uint8 frames more than 1e-3 apart":
        got["obs_stack"].view(-1)[:int(2e-3 * n)] = 1
        return want, got, dict(ok=False, envs_ok=False)
    if name == "uint8 frames less than 1e-3 apart":
        got["obs_stack"].view(-1)[:int(0.5e-3 * n)] = 1
        return want, got, dict(ok=True, bit_equal=False, envs_ok=True)
    if name == "a float env row inside atol 1e-4":
        got["env_state"]["agent_states"][3, 1, 2] += 5e-5
        return want, got, dict(ok=True, bit_equal=False, envs_ok=True)
    if name == "a float env row outside atol 1e-4":
        got["env_state"]["agent_states"][3, 1, 2] += 5e-4
        return want, got, dict(ok=False, envs_ok=False)
    got["env_state"]["step_idx"][2] += 1     # an integer env row differs
    return want, got, dict(ok=False, envs_ok=False)


@pytest.mark.parametrize("name", [
    "equal trees", "the generator state differs", "the step count differs",
    "uint8 frames more than 1e-3 apart", "uint8 frames less than 1e-3 apart",
    "a float env row inside atol 1e-4", "a float env row outside atol 1e-4",
    "an integer env row differs"])
def test_carry_close(name):
    want, got, expect = _carry_case(name)
    res = cs.carry_close(got, want)
    assert {k: res[k] for k in expect} == expect


def _rows(steps=3, b=4):
    g = torch.Generator().manual_seed(0)
    return [dict(terminated=torch.zeros(b, dtype=torch.bool),
                 truncated=torch.zeros(b, dtype=torch.bool),
                 step_idx=torch.full((b,), t, dtype=torch.int32),
                 case=torch.arange(b, dtype=torch.int32),
                 agent_states=torch.rand(b, 6, 4, generator=g) * 50.0,
                 obs=torch.zeros(b, 3, 16, 16, dtype=torch.uint8))
            for t in range(steps)]


def _rows_case(name):
    want = _rows()
    got = [{k: v.clone() for k, v in r.items()} for r in _rows()]
    total = want[0]["obs"].numel()
    if name == "equal rows":
        return want, got, dict(exact=True, states_ok=True, pixels_ok=True)
    if name == "one terminated flag flipped":
        got[1]["terminated"][2] = True
        return want, got, dict(exact=False, states_ok=True, pixels_ok=True)
    if name == "pixels over the 1e-3 share":
        got[2]["obs"].view(-1)[:int(1e-3 * total) + 1] = 7
        return want, got, dict(exact=True, states_ok=True, pixels_ok=False)
    if name == "pixels at the 1e-3 share":
        got[2]["obs"].view(-1)[:int(1e-3 * total)] = 7
        return want, got, dict(exact=True, states_ok=True, pixels_ok=True)
    got[0]["agent_states"][1, 2, 0] += 1e-3  # a state outside atol 1e-4
    return want, got, dict(exact=True, states_ok=False, pixels_ok=True)


@pytest.mark.parametrize("name", [
    "equal rows", "one terminated flag flipped", "pixels over the 1e-3 share",
    "pixels at the 1e-3 share", "a state outside atol 1e-4"])
def test_compare_rows(name):
    want, got, expect = _rows_case(name)
    res = cs._compare_rows(got, want)
    assert {k: res[k] for k in expect} == expect


@pytest.mark.parametrize("got, want, close", [
    ({"loss": 1.0}, {"loss": 1.0, "alpha": 0.02}, False),
    ({"loss": 1.0 + 5e-5, "alpha": 0.02}, {"loss": 1.0, "alpha": 0.02}, True),
    ({"loss": 1.0 + 2e-4, "alpha": 0.02}, {"loss": 1.0, "alpha": 0.02}, False),
], ids=["differing keys", "inside METRIC_TOL", "outside METRIC_TOL"])
def test_metrics_close(got, want, close):
    assert cs._metrics_close(got, want) is close


@pytest.mark.parametrize("first, n, renders, want", [
    (0, 4, 2, 4),          # eager and capture, two renders each
    (0, 1, 2, 2),          # the eager call alone
    (1, 4, 2, 2),          # the capture, then replays
    (2, 4, 2, 0),          # replays only
    (0, 200, 1, 2),        # an evaluation's steps, one render each
    (1, 1, 1, 1),
    (5, 3, 1, 0),
])
def test_host_launches(first, n, renders, want):
    assert cs.host_launches(first, n, renders=renders) == want
