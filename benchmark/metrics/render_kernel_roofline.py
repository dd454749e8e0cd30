"""The rasterizer kernel's share of its roofline: the least time of each
traced step's render, counted from that step's own inputs by the frozen
``render_cost`` (the segments and primitives that survive the kernel's
culls; bytes at the HBM rate, operations at the f32 rate), summed, over
the kernel's device time in the trace. The count reads the same work
whatever implements the kernel; no kernel of that name in the trace reads
nothing."""

from benchmark.metrics import _costs

MOVES = "env_steps_per_s"
KERNEL = "render_obs_kernel"


def read(r):
    t, traced = r.get("trace"), r.get("traced")
    if not t or not traced:
        return None
    durs = [e["dur"] for e in t["kernels"] if KERNEL in e["name"]]
    if not durs:
        return None
    ref = r["ref"]
    cfg, assets = ref["cfg"], ref["assets"]
    rc = cfg.simulator.renderer
    least = 0.0
    for states in traced:
        for state in states.rendered:
            prep = _costs.render_inputs(cfg, assets, state)
            cost = _costs.render_cost(assets.maps, state.town, *prep,
                                      res=rc.obs_res, fov=rc.obs_fov,
                                      left_handed=rc.left_handed_coordinates)
            least += _costs.least_s(cost)[0]
    return 100.0 * least / (sum(durs) * 1e-6)
