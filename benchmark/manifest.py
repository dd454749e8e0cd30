"""Everything a run finds by name: the cell in ``BENCHMARK.json``, its
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) with the module of its actions' kind
(``actions/<kind>.py``), its driver (``drivers/<driver>.py``, named by the
configuration) and each per-layer metric's reader
(``metrics/<metric>.py``)."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def load_manifest(path: str = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def config(manifest: dict, name: str) -> dict:
    """The configuration file that ``BENCHMARK.json`` names for ``name``."""
    for c in manifest["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return _json("traffic", f"{name}.json")


def driver(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.drivers.{name}")


def metric_reader(name: str) -> ModuleType:
    """``metrics/<name>.py``, loaded from its path (a metric's name may hold
    dots): it has ``MOVES``, the end-to-end metric it moves, and
    ``read(readings) -> float or None``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_cell(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(manifest: dict, cell_name: str) -> List[dict]:
    return [m for m in manifest["end_to_end"] if _in_cell(m, cell_name)]


def per_layer(manifest: dict, cell_name: str) -> List[dict]:
    return [m for m in manifest["per_layer"] if _in_cell(m, cell_name)]


def merged(base: Dict, over: Dict) -> Dict:
    """``base`` with ``over``'s keys laid over it, nested groups merged."""
    out = dict(base)
    for k, v in over.items():
        out[k] = (merged(out[k], v) if isinstance(v, dict)
                  and isinstance(out.get(k), dict) else v)
    return out
