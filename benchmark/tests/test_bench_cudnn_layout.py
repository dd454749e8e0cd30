"""``cudnn_layout_kernels_per_train_step`` on synthetic readings: cuDNN's
conversion kernels counted over the traced train steps, 0 where the trace
holds none, nothing where there is no trace."""

import pytest

from benchmark import manifest

NAME = "cudnn_layout_kernels_per_train_step"
TO_NHWC = ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16,"
           " __nv_bfloat16, float, false, true, (cudnnKernelDataType_t)0>")
TO_NCHW = ("void cudnn::engines_precompiled::nhwcToNchwKernel<__nv_bfloat16,"
           " __nv_bfloat16, float, true, false, (cudnnKernelDataType_t)0>")
OTHER = ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
         "optimized_bf16_64x64_64x4_nhwc_align8>")


def _readings(names, steps=2):
    return {"trace": {"kernels": [{"name": n, "dur": 1.0} for n in names]},
            "trace_steps": steps}


def _read(r):
    return manifest.metric_reader(NAME).read(r)


def test_counts_the_conversions_over_the_traced_steps():
    names = [TO_NHWC] * 5 + [TO_NCHW] * 3 + [OTHER] * 7
    assert _read(_readings(names)) == pytest.approx(4.0)
    assert _read(_readings([TO_NCHW], steps=1)) == 1.0


def test_reads_zero_where_no_conversion_ran():
    assert _read(_readings([OTHER] * 9)) == 0.0
    assert _read(_readings([])) == 0.0


@pytest.mark.parametrize("r", [{}, {"trace": None, "trace_steps": 1},
                               {"trace": {"kernels": [{"name": TO_NHWC}]}},
                               _readings([TO_NHWC], steps=0)])
def test_reads_nothing_without_a_trace(r):
    assert _read(r) is None


def test_declared_for_the_sac_cell():
    m = manifest.load_manifest()
    spec = next(x for x in m["per_layer"] if x["name"] == NAME)
    assert spec["workloads"] == ["sac_stage1.steady"]
    assert spec["moves"] == manifest.metric_reader(NAME).MOVES
    assert spec["layer"] == "updates (rl/sac.py update)"
