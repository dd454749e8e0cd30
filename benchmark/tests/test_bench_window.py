"""The window's arithmetic on synthetic event times."""

import pytest

from benchmark import manifest, window


def test_rate_is_all_work_over_all_time():
    # 4096 envs x 100 steps in a window of 2.5 s with a 1 s stall inside:
    # the stall counts
    assert window.rate(4096 * 100, 2.5) == pytest.approx(163840.0)
    with pytest.raises(ValueError):
        window.rate(1, 0.0)


def test_p95_over_every_interval():
    # events after each step: 95 steps of 10 ms and 5 of 60 ms (resets)
    t, stamps = 0.0, [0.0]
    for i in range(100):
        t += 60.0 if i % 20 == 7 else 10.0
        stamps.append(t)
    gaps = window.intervals_ms(stamps)
    assert len(gaps) == 100
    assert window.percentile(gaps, 95) == pytest.approx(10.0)
    assert window.percentile(gaps, 96) == pytest.approx(60.0)
    assert window.percentile(gaps, 100) == pytest.approx(60.0)
    assert window.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        window.percentile([], 95)


def test_train_rate_counts_whole_train_steps():
    # 512 transitions a train step, 24 whole train steps in 30.1 s
    assert window.rate(24 * 512, 30.1) == pytest.approx(408.2392, rel=1e-6)


def test_train_rate_stands_per_layer():
    # the window's rate, read where the driver left it; nothing to read,
    # no reading
    reader = manifest.metric_reader("train_env_steps_per_s.window")
    assert reader.MOVES == "train_step_device_ms"
    assert reader.read({"train_env_steps_per_s": 408.2392}) == 408.2392
    assert reader.read({}) is None
