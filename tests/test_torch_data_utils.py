"""The port's scenario loaders (``data_utils.py``, ``maps/compile.py``,
``config.Scenario`` / ``WaypointSuite``) against the JAX package's.

The bundled train and validation suites are written back out as waypoint
suite YAML files (every waypoint, scenario agent and replayed sequence of
the compiled npz) and as scenario-builder JSON exports; both packages load
them, and ``suite_to_arrays`` must give the same arrays on both sides, equal
to the bundled ones: exact, dtypes included. Python's ``random`` (which
``load_labeled_data`` draws start speeds from) is seeded alike before each
side. ``load_default_*`` equals ``load_assets``' suites, and a
``BatchedEnv`` resets and steps on a suite compiled at run time.
"""

import dataclasses
import json
import os
import random

import numpy as np
import pytest
import torch
import yaml

from torchdriveenv_tpu import data_utils as jdu
from torchdriveenv_tpu.maps import compile as jmc
from torchdriveenv_tpu_torch import data_utils as tdu
from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env.batched import BatchedEnv
from torchdriveenv_tpu_torch.maps import compile as tmc
from torchdriveenv_tpu_torch.maps.arrays import SuiteArrays, load_assets

torch.set_num_threads(2)
ASSETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "torchdriveenv_tpu", "assets")
SUITE_FIELDS = [f.name for f in dataclasses.fields(SuiteArrays)]


def _bundled(suite):
    return np.load(os.path.join(ASSETS, f"suite_{suite}_v1.npz"))


def _assert_arrays_equal(got, want, where):
    for k in SUITE_FIELDS:
        g = getattr(got, k)
        w = np.asarray(want[k] if isinstance(want, (dict, np.lib.npyio.NpzFile))
                       else getattr(want, k))
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.numpy().dtype == w.dtype, f"{where}: {k} {g.dtype}"
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{where}: {k}")


def test_compile_constants_match_jax():
    assert tmc.TOWNS == jmc.TOWNS
    assert (tmc.MAX_WAYPOINTS, tmc.MAX_SCEN_AGENTS, tmc.MAX_REPLAY_T) == (
        jmc.MAX_WAYPOINTS, jmc.MAX_SCEN_AGENTS, jmc.MAX_REPLAY_T)


@pytest.mark.parametrize("suite", ["val", "train"])
def test_waypoint_suite_yaml_matches_jax(tmp_path, suite):
    z = _bundled(suite)
    path = tmp_path / "suite.yml"
    path.write_text(yaml.safe_dump(tmc.suite_from_bundle(z)))
    jdata = jdu.load_waypoint_suite_data(str(path))
    tdata = tdu.load_waypoint_suite_data(str(path))
    assert dataclasses.asdict(tdata) == dataclasses.asdict(jdata)
    if suite == "val":
        assert type(tdata.scenarios[0]).__module__ == (
            "torchdriveenv_tpu_torch.config")
    tarr = tdu.suite_to_arrays(tdata, device="cpu")
    _assert_arrays_equal(tarr, jdu.suite_to_arrays(jdata), f"{suite} vs JAX")
    _assert_arrays_equal(tarr, z, f"{suite} vs the bundle")


def _builder_json(z, c):
    """A scenario-builder export of case ``c``: its route, a parked car
    (``max_speed`` 0), a car with one state (a random start speed) and, where
    the case replays one, a car with logged states."""
    def state(x, y, psi):
        return {"center": {"x": float(x), "y": float(y)},
                "orientation": float(psi)}

    wps = z["waypoints"][c, :int(z["n_waypoints"][c])]
    attrs = {"length": 4.5, "width": 1.9, "rear_axis_offset": 1.2}
    agents = {
        "1": {"states": {"0": state(*wps[1], 0.3)},
              "static_attributes": dict(attrs, max_speed=0)},
        "2": {"states": {"0": state(*wps[2], -1.1)},
              "static_attributes": dict(attrs, max_speed=12)},
    }
    seq = z["replay_states"][c, 1, :int(z["replay_mask"][c, 1].sum())]
    if len(seq):
        agents["3"] = {"states": {str(i): state(*s[:3])
                                  for i, s in enumerate(seq[:50])},
                       "static_attributes": attrs}
    return {"individual_suggestions": {"0": {"states": [
        state(x, y, 0.0) for x, y in wps]}},
        "predetermined_agents": agents}


def test_labeled_json_matches_jax(tmp_path):
    z = _bundled("val")
    for c in range(z["case_town"].shape[0]):
        town = tmc.TOWNS[int(z["case_town"][c])]
        (tmp_path / f"case{c}_{town}_export.json").write_text(
            json.dumps(_builder_json(z, c)))
    (tmp_path / "notes.txt").write_text("not an export")
    random.seed(11)
    jdata = jdu.load_labeled_data(str(tmp_path))
    random.seed(11)
    tdata = tdu.load_labeled_data(str(tmp_path))
    assert dataclasses.asdict(tdata) == dataclasses.asdict(jdata)
    assert len(tdata.locations) == z["case_town"].shape[0]
    speeds = [s.agent_states[1][3] for s in tdata.scenarios]
    assert all(5 <= v <= 10 for v in speeds) and len(set(speeds)) > 1
    assert any(len(cs) == 2 for cs in tdata.car_sequence_suite)
    tarr = tdu.suite_to_arrays(tdata, device="cpu")
    _assert_arrays_equal(tarr, jdu.suite_to_arrays(jdata), "builder JSON")
    # the parked car replays its pose for 200 steps, the logged car its log
    assert tarr.replay_mask[:, 1].sum(-1).tolist() == [200] * len(speeds)
    assert tarr.replay_mask[:, 3].sum(-1).max() == 50


@pytest.mark.parametrize("suite", ["train", "val"])
def test_default_data_equals_load_assets(suite):
    load = (tdu.load_default_train_data if suite == "train"
            else tdu.load_default_validation_data)
    got = load(device="cpu")
    want = load_assets(suite, device="cpu").suite
    for k in SUITE_FIELDS:
        assert torch.equal(getattr(got, k), getattr(want, k)), k
    jload = (jdu.load_default_train_data if suite == "train"
             else jdu.load_default_validation_data)
    _assert_arrays_equal(got, jload(), f"{suite} vs JAX")


def test_default_data_needs_a_device_name_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdu.load_default_validation_data()


def test_batched_env_runs_on_a_compiled_suite(tmp_path):
    """A suite authored in YAML (two validation routes, reversed, with
    their scenario agents) drives the env: episodes start on the route's
    first segment, and the scenario agents are placed."""
    z = _bundled("val")
    raw = tmc.suite_from_bundle(z)
    raw = {k: [v[0], v[3]] for k, v in raw.items()}
    raw["waypoint_suite"] = [w[::-1] for w in raw["waypoint_suite"]]
    path = tmp_path / "suite.yml"
    path.write_text(yaml.safe_dump(raw))
    suite = tdu.suite_to_arrays(tdu.load_waypoint_suite_data(str(path)),
                                device="cpu")
    assets = dataclasses.replace(load_assets("val", device="cpu"), suite=suite)
    env = BatchedEnv(EnvConfig(), assets, 6, device="cpu", seed=1)
    state, obs = env.reset()
    assert obs.shape == (6, 3, 64, 64) and obs.dtype == torch.uint8
    case = state.case.long()
    assert set(case.tolist()) <= {0, 1}
    wps = suite.waypoints[case]
    seg = wps[:, 1] - wps[:, 0]
    rel = state.agent_states[:, 0, :2] - wps[:, 0]
    frac = (rel * seg).sum(-1) / (seg * seg).sum(-1)
    assert ((frac >= -1e-4) & (frac <= 1 + 1e-4)).all()
    cross = rel[:, 0] * seg[:, 1] - rel[:, 1] * seg[:, 0]
    assert (cross.abs() / seg.norm(dim=-1) < 1e-3).all()
    # slots 1..S hold the case's scenario agents where they are placed
    s = suite.scen_mask.shape[1]
    scen = suite.scen_mask[case]
    assert scen.any() and torch.equal(state.present[:, 1:1 + s], scen)
    assert torch.equal(state.agent_states[:, 1:1 + s, :2][scen],
                       suite.scen_states[case][..., :2][scen])
    for _ in range(3):
        out = env.step(state, torch.tensor([[0.5, 0.0]]).repeat(6, 1))
        state = out.state
        assert torch.isfinite(state.agent_states).all()
        assert torch.isfinite(out.reward).all() and out.obs.shape == obs.shape
