"""The check that decides ``correct``, driven through whole runs on the
CPU at small sizes: a sound run is correct, its readings at their least;
the control (the reference one precision lower in the program's place) is
not; nor is a run with the timed path broken underneath
(``benchmark/faults.py``). On the card the same readings are taken at the
cells' own sizes: ``python3 -m benchmark.control``.

Env cells: 16 envs, a pool of 4, episodes of at most 5 steps, so that the
pooled reset runs; the compared steps drawn from the window's first 4
(the CPU's few steps a second). The training cell: 8 envs, 2 of them scripted, batches
of 16, 2 updates a train step."""

import pytest
import torch

from benchmark import compare, control, faults, run

ENV_SIZES = {"num_envs": 16, "sample_rate": 2,
             "env": {"reset_pool": 4, "max_environment_steps": 5}}
ENV_CELLS = ("env_main.idm_explore", "env_main.gru_explore")
SAC_CELL = "sac_stage1.steady"
SAC_SIZES = {"num_envs": 8, "algo": {"batch_size": 16, "buffer_size": 2048},
             "updates_per_iter": 2, "demo_envs": 2}


def _run(workload, seed, sizes, fault=None):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", "1.0"])
    return run.run_cell(run.context(args, "cpu", sizes=sizes, fault=fault))


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.parametrize("workload", ENV_CELLS)
def test_env_sound_run_and_control(workload):
    r = control.readings(workload, 2147483650, 2.0, "cpu", sizes=ENV_SIZES)
    # the two drawn from the seed and the one after the window
    assert r["compared_steps"] == 3
    assert r["program"] == {"flipped_envs": 0.0, "float_gap": 0.0,
                            "pixels_off": 0.0}
    assert _fails(r["control"], r["limits"]), r["control"]


@pytest.mark.parametrize("fault", sorted(faults.ENV_FAULTS))
def test_env_broken_timed_path_is_not_correct(fault):
    line = _run(ENV_CELLS[0], 2147483651, ENV_SIZES, faults.ENV_FAULTS[fault])
    assert line["correct"] is False, line["checks"]


def test_env_sound_run_is_correct():
    assert _run(ENV_CELLS[0], 2147483651, ENV_SIZES)["correct"] is True


def test_sac_sound_run_and_control():
    r = control.readings(SAC_CELL, 2147483652, 1.0, "cpu", sizes=SAC_SIZES)
    p = r["program"]
    assert p["loss_gap"] == 0.0 and p["change_gap"] == 0.0
    # Adam's first moment over (1 - beta1) gives the gradient back to
    # rounding
    assert p["grad_gap"] < 1e-5
    assert not _fails(p, r["limits"])
    assert _fails(r["control"], r["limits"]), r["control"]


@pytest.mark.parametrize("fault", sorted(faults.TRAIN_FAULTS))
def test_sac_broken_update_is_not_correct(fault):
    line = _run(SAC_CELL, 2147483653, SAC_SIZES, faults.TRAIN_FAULTS[fault])
    assert line["correct"] is False, line["checks"]


def test_tally_readings():
    t = compare.Tally()
    flipped = torch.tensor([False, True, False, False])
    gap = torch.tensor([0.5, 1e9, 2.0, 0.0])
    fp = torch.zeros(4, 3, 2, 2, dtype=torch.uint8)
    fr = fp.clone()
    fr[1] = 7          # a flipped env's frame is not counted
    fr[2, 0, 0, 0] = 1
    t.add(flipped, gap, [fp], [fr])
    assert t.readings() == {"flipped_envs": 0.25, "float_gap": 2.0,
                            "pixels_off": 1 / 36}
