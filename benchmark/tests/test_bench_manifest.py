"""BENCHMARK.json against the contract the harness and the driver hold it
to, and every name in it resolved to its file."""

import json
import os
import re

import pytest

from benchmark import gen, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@pytest.fixture(scope="module")
def m():
    return manifest.load_manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(m):
    assert set(m) == TOP_KEYS
    assert os.path.getsize(manifest.MANIFEST) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16
    for p in m["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert os.path.isdir(os.path.join(manifest.ROOT, p))
    assert 1 <= len(m["command"]) <= 32
    assert all(_line(w) for w in m["command"])
    # every run of a full check of 24 cells fits the check's time
    rs = m["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_resolve(m):
    assert 1 <= len(m["configs"]) <= 24
    for c in m["configs"]:
        assert set(c) == CONFIG_KEYS
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))
        cfg = manifest.config(m, c["name"])
        assert cfg["name"] == c["name"]
        assert sorted(c["reduced"]) == sorted(cfg["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])
        manifest.driver(cfg["driver"])
        assert any(w["config"] == c["name"] for w in m["workloads"])
    files = [c["file"] for c in m["configs"]]
    assert len(set(files)) == len(files)


def test_cells_resolve(m):
    cells = m["workloads"]
    assert 1 <= len(cells) <= 24
    names = [w["name"] for w in cells]
    assert len(set(names)) == len(names)
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == CELL_KEYS and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
        cfg = manifest.config(m, w["config"])
        traffic = manifest.traffic(w["traffic"])
        gen.action_kind(traffic["actions"]["kind"])
        manifest.driver(cfg["driver"])


def test_metrics(m):
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = list(e2e) + [x["name"] for x in m["per_layer"]]
    assert len(set(names)) == len(names)
    cells = [w["name"] for w in m["workloads"]]
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == E2E_KEYS
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
        assert set(x.get("workloads", cells)) <= set(cells)
    layers = {}
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == LAYER_KEYS
        assert x["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(x["layer"])
        assert x["moves"] in e2e
        reader = manifest.metric_reader(x["name"])
        assert reader.MOVES == x["moves"]
        # every cell that reports the metric reports the metric it moves
        for c in x.get("workloads", cells):
            assert c in cells
            assert x["moves"] in [e["name"] for e in
                                  manifest.end_to_end(m, c)]
        layers.setdefault(x["layer"], x["layer"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")


def test_every_cell_reports_enough(m):
    for w in m["workloads"]:
        e2e = [x["name"] for x in manifest.end_to_end(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(m, w["name"])


def test_traffic_files_are_data():
    tdir = os.path.join(manifest.BENCH_DIR, "traffic")
    for f in os.listdir(tdir):
        assert f.endswith((".json", ".jsonl", ".toml", ".txt", ".csv")), f
        if f.endswith(".json"):
            with open(os.path.join(tdir, f)) as fh:
                json.load(fh)
