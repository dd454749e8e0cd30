"""The port's map-fidelity audit (``tools/audit_map_fidelity.py``) against
the JAX tool's: every audit's result dict on both suites and the background
caches, counts and violations exact, the float readings within 1e-5. The
shipped assets have no violation, so the audits also run on perturbed
assets (waypoints, scenario agents, replay poses and background agents
pushed sideways, segment index rows blanked), where they must count the
same violations. The port's ``main`` exits 0 on the shipped assets and 1
where it finds a violation."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tools import audit_map_fidelity as jaudit
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.tools import audit_map_fidelity as taudit

torch.set_num_threads(2)
SUITE_AUDITS = ("audit_waypoints", "audit_spawn_segments",
                "audit_scenario_agents", "audit_replay_poses",
                "audit_render_coverage")


def _close(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, float):
            assert got[k] == pytest.approx(w, rel=1e-5, abs=1e-5), k
        else:
            assert got[k] == w and type(got[k]) is type(w), k


@pytest.fixture(scope="module", params=["train", "val"])
def suites(request):
    return request.param, jload(request.param), tload(request.param,
                                                       device="cpu")


@pytest.mark.parametrize("audit", SUITE_AUDITS)
def test_suite_audit_matches_jax(suites, audit):
    name, ja, ta = suites
    _close(getattr(taudit, audit)(ta, name), getattr(jaudit, audit)(ja, name))


def test_background_audit_matches_jax():
    _close(taudit.audit_background(tload("val", device="cpu")),
           jaudit.audit_background(jload("val")))


def _shifted(x: np.ndarray, metres: float) -> np.ndarray:
    """Every other pose pushed ``metres`` along y (x and y columns first)."""
    x = np.array(x)
    x[..., ::2, 1] += metres
    return x


def _perturbed(suite):
    """The same perturbation of both packages' assets."""
    ja = jload(suite)
    js, jb = ja.suite, ja.background
    wp = _shifted(np.asarray(js.waypoints), 9.0)
    scen = _shifted(np.asarray(js.scen_states), 7.0)
    replay = _shifted(np.asarray(js.replay_states), 30.0)
    bg = _shifted(np.asarray(jb.bg_states), 8.0)
    seg = np.array(ja.maps.seg_data)
    seg[:, ::3, :, :, 4] = 0.0              # a third of the cells: no rows
    ja = ja.replace(
        suite=js.replace(waypoints=jnp.asarray(wp),
                         scen_states=jnp.asarray(scen),
                         replay_states=jnp.asarray(replay)),
        background=jb.replace(bg_states=jnp.asarray(bg)),
        maps=ja.maps.replace(seg_data=jnp.asarray(seg)))
    ta = tload(suite, device="cpu")
    ta = dataclasses.replace(
        ta,
        suite=dataclasses.replace(ta.suite, waypoints=torch.from_numpy(wp),
                                  scen_states=torch.from_numpy(scen),
                                  replay_states=torch.from_numpy(replay)),
        background=dataclasses.replace(ta.background,
                                       bg_states=torch.from_numpy(bg)),
        maps=dataclasses.replace(ta.maps, seg_data=torch.from_numpy(seg)))
    return ja, ta


@pytest.mark.parametrize("suite", ["train", "val"])
def test_violations_are_counted_alike(suite):
    ja, ta = _perturbed(suite)
    found = 0
    for audit in SUITE_AUDITS:
        want = getattr(jaudit, audit)(ja, suite)
        _close(getattr(taudit, audit)(ta, suite), want)
        found += want["violations"]
    want = jaudit.audit_background(ja)
    _close(taudit.audit_background(ta), want)
    assert want["violations"] > 0 and found > 0


def test_main_exits_zero_on_the_shipped_assets(tmp_path):
    out = tmp_path / "audit.json"
    assert taudit.main(["--device", "cpu", "--json", str(out)]) == 0
    report = json.loads(out.read_text())
    assert len(report) == 11 and all(r["ok"] for r in report)


def test_main_exits_one_on_a_violation(monkeypatch):
    plain = taudit.audit_waypoints

    def bad(assets, suite_name):
        return dict(plain(assets, suite_name), violations=1)

    monkeypatch.setattr(taudit, "audit_waypoints", bad)
    assert taudit.main(["--device", "cpu"]) == 1


def test_the_audit_needs_a_gpu_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        taudit.main([])
