"""The collectives' bus bandwidth as a share of the link's peak: the
program's counter ``mesh.collective_bytes`` x 2 (W - 1) / W (a ring's
traffic a rank) over the nccl kernels' time in rank 0's traced train step,
against NVLink 4's 450 GB/s a direction (``_ppo_costs``). The kernels'
time holds their wait for the slowest peer, so a low share means waiting,
not bandwidth."""

from benchmark.metrics import _ppo_costs, _spans

MOVES = "env_steps_per_s"


def read(r):
    t, log, world = r.get("trace"), _spans.log(), r.get("world", 1)
    if not t or not log or world < 2:
        return None
    nbytes = log[1].get("mesh.collective_bytes")
    kernel_s = sum(k["dur"] for k in _ppo_costs.nccl_kernels(t)) * 1e-6
    if not nbytes or kernel_s <= 0:
        return None
    busbw = nbytes * 2 * (world - 1) / world / kernel_s
    return 100.0 * busbw / _ppo_costs.NVLINK_PEAK_BYTES
