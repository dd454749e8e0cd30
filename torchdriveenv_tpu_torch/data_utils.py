"""Scenario data loading: the reference's ``env_utils.py`` surface (port of
``torchdriveenv_tpu/data_utils.py``).

The same loaders: ``load_env_config``, ``load_waypoint_suite_data`` (a
waypoint-suite YAML), ``load_labeled_data`` (a directory of scenario-builder
JSON exports), ``load_default_train_data`` / ``load_default_validation_data``
(the bundled suites, read by path from the compiled npz files), and
``suite_to_arrays``, which turns a Python ``WaypointSuite`` into the padded
``SuiteArrays`` the env reads, so user-authored scenario files run without
the offline compiler. ``device=None`` means the GPU, as everywhere in the
port. PyYAML is imported only where a YAML file is opened.
"""

from __future__ import annotations

import json
import os
import random
from typing import Optional

import numpy as np

import torchdriveenv_tpu_torch
from torchdriveenv_tpu_torch.config import (  # noqa: F401
    Scenario,
    WaypointSuite,
    load_env_config,
)
from torchdriveenv_tpu_torch.maps import compile as mc
from torchdriveenv_tpu_torch.maps.arrays import (
    SuiteArrays,
    resolve_device,
    suite_from_numpy,
)


def load_waypoint_suite_data(yaml_path: str) -> WaypointSuite:
    """Reference env_utils.py:20-28."""
    import yaml
    with open(yaml_path) as f:
        raw = yaml.safe_load(f)
    data = WaypointSuite(**raw)
    if data.scenarios is not None:
        data.scenarios = [
            Scenario(agent_states=s["agent_states"],
                     agent_attributes=s["agent_attributes"],
                     recurrent_states=s.get("recurrent_states"))
            if s is not None else None
            for s in data.scenarios
        ]
    return data


def load_labeled_data(data_dir: str) -> WaypointSuite:
    """Ingest scenario-builder JSON exports (reference env_utils.py:31-105):
    waypoints from ``individual_suggestions['0'].states``, predetermined
    agents become scenario agents, stationary (``max_speed == 0``) agents
    become 200-frame constant replays, multi-state agents replay their
    logged states. Single-state agents get a start speed from Python's
    ``random`` (``randint(5, 10)``), as the reference draws it."""
    suite = WaypointSuite(locations=[], waypoint_suite=[],
                          car_sequence_suite=[], scenarios=[])
    for json_file in sorted(os.listdir(data_dir)):
        if not json_file.endswith(".json"):
            continue
        suite.locations.append(json_file.split("_")[1])
        with open(os.path.join(data_dir, json_file)) as f:
            data = json.load(f)

        waypoints = [[s["center"]["x"], s["center"]["y"]]
                     for s in data["individual_suggestions"]["0"]["states"]]
        suite.waypoint_suite.append(waypoints)

        scenario = None
        car_sequences = None
        agents = data.get("predetermined_agents")
        if agents:
            states, attrs = [], []
            for aid in agents:
                agent = agents[aid]
                speed = random.randint(5, 10) if len(agent["states"]) == 1 else 0
                st0 = agent["states"]["0"]
                states.append([st0["center"]["x"], st0["center"]["y"],
                               st0["orientation"], speed])
                sa = agent["static_attributes"]
                attrs.append([sa["length"], sa["width"], sa["rear_axis_offset"]])
            if states:
                scenario = Scenario(agent_states=states, agent_attributes=attrs,
                                    recurrent_states=None)
            car_sequences = {}
            for aid in agents:
                agent = agents[aid]
                sa = agent["static_attributes"]
                st0 = agent["states"]["0"]
                pose0 = [st0["center"]["x"], st0["center"]["y"],
                         st0["orientation"], 0]
                if sa.get("max_speed") == 0:
                    car_sequences[int(aid)] = [list(pose0) for _ in range(200)]
                elif len(agent["states"]) > 1:
                    car_sequences[int(aid)] = [
                        [agent["states"][i]["center"]["x"],
                         agent["states"][i]["center"]["y"],
                         agent["states"][i]["orientation"], 0]
                        for i in agent["states"]
                    ]
        suite.scenarios.append(scenario)
        suite.car_sequence_suite.append(car_sequences)
    return suite


def _default_data_path(file_name: str) -> Optional[str]:
    for root in torchdriveenv_tpu_torch._data_path:
        p = os.path.join(root, file_name)
        if os.path.exists(p):
            return p
    return None


def load_default_train_data(device=None) -> SuiteArrays:
    """Reference env_utils.py:122-123: the 100 bundled training cases, as
    precompiled arrays on ``device``."""
    return _load_precompiled("suite_train_v1.npz", device)


def load_default_validation_data(device=None) -> SuiteArrays:
    """Reference env_utils.py:118-119: the 5 validation scenarios."""
    return _load_precompiled("suite_val_v1.npz", device)


def _load_precompiled(file_name: str, device) -> SuiteArrays:
    dev = resolve_device(device)
    p = _default_data_path(file_name)
    if p is None:
        raise FileNotFoundError(f"compiled asset {file_name} not found")
    return suite_from_numpy(np.load(p), dev)


def suite_to_arrays(data: WaypointSuite, device=None) -> SuiteArrays:
    """Compile a Python ``WaypointSuite`` into padded ``SuiteArrays`` on
    ``device`` at run time (no reference analogue: the reference re-parses
    YAML per run). Put them in an ``Assets`` in place of the bundled suite
    (``dataclasses.replace(assets, suite=...)``)."""
    dev = resolve_device(device)
    raw = dict(
        locations=data.locations,
        waypoint_suite=data.waypoint_suite,
        car_sequence_suite=data.car_sequence_suite,
        scenarios=[
            dict(agent_states=s.agent_states, agent_attributes=s.agent_attributes,
                 recurrent_states=s.recurrent_states) if s is not None else None
            for s in data.scenarios
        ] if data.scenarios is not None else None,
    )
    return suite_from_numpy(mc.compile_suite(raw), dev)
