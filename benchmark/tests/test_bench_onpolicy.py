"""The on-policy driver (``drivers/onpolicy.py``) through whole runs of
``ppo_16k.w4`` on the CPU at a small size: four gloo ranks (rank 0 this
process, ranks 1-3 started by the driver), 16 envs (4 a rank) with a pool
of 3 (so that a rank's share of the pool starts elsewhere than at 0) and
episodes of at most 5 steps, 4 env steps and 2 epochs of minibatches of 16
a train step (the compared one train step 1, the first with a truncation). A sound run is correct and its ranks
bit-equal; the control is not; nor is a run with a fault across cards
planted (``faults_cards.py``). The per-layer metrics read the traced train
step's spans and counters, and read nothing where the program has none."""

import pytest

from benchmark import control, faults_cards, manifest, run

CELL = "ppo_16k.w4"
SIZES = {"num_envs": 16,
         "algo": {"n_steps": 4, "batch_size": 16, "n_epochs": 2},
         "env": {"reset_pool": 3, "max_environment_steps": 5}}
GRAD_STEPS = 2 * 4 * 16 // 16


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


def test_sound_run_and_control():
    r = control.readings(CELL, 2147483660, 1.0, "cpu", sizes=SIZES)
    p = r["program"]
    assert set(p) == set(r["limits"])
    assert p["rank_gap"] == 0.0
    assert p["flipped_envs"] == p["float_gap"] == p["pixels_off"] == 0.0
    assert r["compared_done_envs"] > 0
    assert not _fails(p, r["limits"]), p
    assert _fails(r["control"], r["limits"]), r["control"]


@pytest.mark.parametrize("fault", sorted(faults_cards.CARD_FAULTS))
def test_fault_across_cards_is_not_correct(fault):
    r = faults_cards.readings(CELL, 2147483661, 1.0, "cpu", fault,
                              sizes=SIZES)
    assert r["correct"] is False, r["program"]


def test_result_line():
    args = run.parse(["--workload", CELL, "--seed", "2147483662",
                      "--seconds", "1.0"])
    line = run.run_cell(run.context(args, "cpu", sizes=SIZES))
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"setup_s", "env_steps_per_s"}
    assert line["device"]["count"] == 4
    assert line["attempted"] == line["steps"] * 4 * 16


def test_span_readers():
    args = run.parse(["--workload", CELL, "--seed", "2147483663",
                      "--seconds", "1.0", "--trace", "1"])
    ctx = run.context(args, "cpu", sizes=SIZES)
    r = manifest.driver("onpolicy").run(ctx)
    specs = manifest.per_layer(manifest.load_manifest(), CELL)
    got = {s["name"]: manifest.metric_reader(s["name"]).read(r)
           for s in specs}
    # a gradient step's three, a pooled reset's one, two a train step
    assert got["collectives_per_train_step"] == 3 * GRAD_STEPS + 4 + 2
    assert got["owned_rows_wait_ms"] > 0
    assert 0 < got["ppo_train_step_mfu"] < 100
    # no card: no stream times and no trace
    for name in ("ppo_update_ms", "rollout_ms", "allreduce_ms_per_train_step",
                 "allreduce_busbw_share", "device_idle_share.ppo"):
        assert got[name] is None, name
    # a program without these spans and counters (as before they were
    # added) leaves no log: every reader of the log reads nothing
    from torchdriveenv_tpu_torch.utils import spans
    spans.clear()
    for name in ("collectives_per_train_step", "owned_rows_wait_ms",
                 "ppo_update_ms", "rollout_ms", "allreduce_busbw_share"):
        assert manifest.metric_reader(name).read(r) is None, name


def test_owned_row_counts_cover_the_draws():
    import torch
    from benchmark.drivers.onpolicy import owned_row_counts
    counts = owned_row_counts(524288, 8192, 0.25)
    assert 2048 in counts and 350 < len(counts) < 420
    g = torch.Generator().manual_seed(2147483664)
    for _ in range(64):
        idx = torch.randperm(524288, generator=g)[:8192]
        assert int(((idx % 16384) < 4096).sum()) in counts
