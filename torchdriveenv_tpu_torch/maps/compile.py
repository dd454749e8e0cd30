"""Scenario-suite compilation: a Python waypoint suite -> the padded per-case
arrays the env reads (``SuiteArrays``). The port's own copy of
``compile_suite`` and the constants it reads from
``torchdriveenv_tpu/maps/compile.py``; the rest of that module, the offline
map compiler, is not part of the runtime. numpy only.
"""

from __future__ import annotations

import numpy as np

TOWNS = ["Town01", "Town02", "Town03", "Town07", "Town10HD"]
MAX_WAYPOINTS = 20     # training cases have 5..20 waypoints
MAX_SCEN_AGENTS = 4    # validation max is 2 predefined agents
MAX_REPLAY_T = 304     # validation max replay length is 300


def compile_suite(suite):
    """Padded per-case arrays (reference schema: gym_env.py:56-68 +
    env_utils.py). ``suite``: a dict with ``locations``, ``waypoint_suite``
    and optional ``scenarios`` / ``car_sequence_suite``."""
    C = len(suite["locations"])
    out = dict(
        case_town=np.zeros((C,), np.int32),
        waypoints=np.zeros((C, MAX_WAYPOINTS, 2), np.float32),
        waypoint_mask=np.zeros((C, MAX_WAYPOINTS), bool),
        n_waypoints=np.zeros((C,), np.int32),
        scen_states=np.zeros((C, MAX_SCEN_AGENTS, 4), np.float32),
        scen_attrs=np.zeros((C, MAX_SCEN_AGENTS, 3), np.float32),
        scen_mask=np.zeros((C, MAX_SCEN_AGENTS), bool),
        replay_states=np.zeros((C, 1 + MAX_SCEN_AGENTS, MAX_REPLAY_T, 4), np.float32),
        replay_mask=np.zeros((C, 1 + MAX_SCEN_AGENTS, MAX_REPLAY_T), bool),
    )
    scen_list = suite.get("scenarios") or [None] * C
    cseq_list = suite.get("car_sequence_suite") or [None] * C
    for c in range(C):
        out["case_town"][c] = TOWNS.index(suite["locations"][c])
        wps = np.asarray(suite["waypoint_suite"][c], np.float32)
        n = len(wps)
        out["waypoints"][c, :n] = wps
        # the reference masks out waypoint 0 as a goal (gym_env.py:256) and
        # starts target indexing at 1 (gym_env.py:325); all waypoints are
        # kept here and the target index starts at 1, the same semantics
        out["waypoint_mask"][c, :n] = True
        out["n_waypoints"][c] = n
        sc = scen_list[c]
        if sc is not None:
            st = np.asarray(sc["agent_states"], np.float32)
            at = np.asarray(sc["agent_attributes"], np.float32)
            k = len(st)
            out["scen_states"][c, :k] = st
            out["scen_attrs"][c, :k] = at
            out["scen_mask"][c, :k] = True
        cs = cseq_list[c]
        if cs:
            for slot, seq in cs.items():
                # merged agent slot: 0 = ego, 1..S = scenario agents
                # (gym_env.py:279)
                slot = int(slot)
                arr = np.asarray(seq, np.float32)
                t = min(len(arr), MAX_REPLAY_T)
                out["replay_states"][c, slot, :t] = arr[:t]
                out["replay_mask"][c, slot, :t] = True
    return out
