"""The torso input kernel's readers on synthetic readings:
``torso_input_kernel_per_update.{train,ppo}`` count the kernel's events
over the traced updates, ``torso_input_roofline.{train,ppo}`` set the
least time of each event's rows (its grid's x) against the events' time;
both read nothing where the kernel is not in the trace, as at a parent
that has no such kernel."""

import pytest

from benchmark import manifest
from benchmark.metrics import _costs, _torso_input

KERNEL = ("(anonymous namespace)::torso_input_kernel(unsigned char const*, "
          "unsigned short*, int, int, int, int, int, int)")
OTHER = "void at::native::elementwise_kernel<128, 4>"
OBS = (9, 64, 64)
LAYER = "torso input (csrc/torso_input.cu)"


def _event(name, rows=512, dur=20.0):
    return {"name": name, "dur": dur, "args": {"grid": [rows, 8, 1],
                                               "block": [256, 1, 1]}}


def _sac(kernels, steps=1):
    return {"trace": {"kernels": kernels}, "trace_steps": steps,
            "updates_per_train_step": 64, "obs_shape": OBS}


def _ppo(kernels):
    return {"trace": {"kernels": kernels}, "trace_steps": 1,
            "env_steps_per_train_step": 32, "num_envs": 16384,
            "algo": {"n_epochs": 4, "batch_size": 8192}, "obs_shape": OBS}


def _read(name, r):
    return manifest.metric_reader(name).read(r)


def test_per_update_counts_the_kernel_over_the_traced_updates():
    sac = [_event(KERNEL)] * 128 + [_event(KERNEL, rows=128)] * 4
    r = _sac(sac + [_event(OTHER)] * 50)
    assert _read("torso_input_kernel_per_update.train", r) == 2.0625
    r = _sac((sac + [_event(OTHER)]) * 2, steps=2)
    assert _read("torso_input_kernel_per_update.train", r) == 2.0625
    ppo = [_event(KERNEL, rows=2048)] * 256 + [_event(KERNEL, rows=4096)] * 65
    assert _read("torso_input_kernel_per_update.ppo", _ppo(ppo)) == 321 / 256


def test_roofline_counts_three_bytes_a_value_of_each_pass():
    r = _sac([_event(KERNEL, rows=512, dur=30.0),
              _event(KERNEL, rows=128, dur=10.0), _event(OTHER, dur=1e6)])
    least = (512 + 128) * 9 * 64 * 64 * 3 / _costs.H100_PEAK_HBM_BYTES
    for name, rr in (("torso_input_roofline.train", r),
                     ("torso_input_roofline.ppo", {**_ppo([]), **r})):
        assert _read(name, rr) == pytest.approx(100 * least / 40e-6)
    assert _torso_input.least_bytes(512, OBS) == 56_623_104
    # at the H100's HBM rate a 512-row pass takes at least 16.9 us
    assert 56_623_104 / _costs.H100_PEAK_HBM_BYTES == pytest.approx(
        16.9e-6, rel=2e-3)


@pytest.mark.parametrize("name", [
    "torso_input_kernel_per_update.train", "torso_input_roofline.train",
    "torso_input_kernel_per_update.ppo", "torso_input_roofline.ppo"])
@pytest.mark.parametrize("trace", [None, {"kernels": []},
                                   {"kernels": [_event(OTHER)]}])
def test_reads_nothing_where_the_kernel_is_not_on_the_path(name, trace):
    r = {**_ppo([]), **_sac([])}
    r["trace"] = trace
    assert _read(name, r) is None


def test_roofline_reads_nothing_without_the_launch_geometry():
    e = _event(KERNEL)
    del e["args"]["grid"]
    assert _read("torso_input_roofline.train", _sac([e])) is None


@pytest.mark.parametrize("name,cell", [
    ("torso_input_kernel_per_update.train", "sac_stage1.steady"),
    ("torso_input_roofline.train", "sac_stage1.steady"),
    ("torso_input_kernel_per_update.ppo", "ppo_16k.w4"),
    ("torso_input_roofline.ppo", "ppo_16k.w4")])
def test_declared_for_its_cell(name, cell):
    m = manifest.load_manifest()
    spec = next(x for x in m["per_layer"] if x["name"] == name)
    assert spec["workloads"] == [cell]
    assert spec["moves"] == manifest.metric_reader(name).MOVES
    assert spec["layer"] == LAYER
    assert any(x["name"] == spec["moves"] and cell in x["workloads"]
               for x in m["end_to_end"])
