"""cuDNN's layout conversions per train step: the trace's kernel events
whose names hold ``nchwToNhwc`` or ``nhwcToNchw`` (cuDNN transposing a
convolution's input, weight or output between NCHW and the NHWC its bf16
tensor-op kernels run in) over the traced train steps. 0 where the torsos
hand cuDNN NHWC tensors; nothing where the run has no trace."""

MOVES = "train_step_device_ms"
KERNELS = ("nchwToNhwc", "nhwcToNchw")


def read(r):
    t = r.get("trace")
    if not t or not r.get("trace_steps"):
        return None
    runs = sum(1 for e in t["kernels"]
               if any(k in e["name"] for k in KERNELS))
    return runs / r["trace_steps"]
