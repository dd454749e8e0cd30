"""The whole env step's share of the card's peaks: the least time of a
step (physics + render + the all-done auto-reset x the share of envs done
per step over the traced steps, from the frozen ``phase_costs`` at the f32
and HBM peaks) over the window's time per step (all its time over all its
steps)."""

from benchmark.metrics import _costs

MOVES = "env_steps_per_s"


def read(r):
    traced = r.get("traced")
    if not traced:
        return None
    ref = r["ref"]
    cfg, assets = ref["cfg"], ref["assets"]
    state = traced[-1].out.state
    costs = _costs.phase_costs(cfg, assets, state,
                               _costs.render_inputs(cfg, assets, state),
                               ref["npc"])
    b = state.town.shape[0]
    done = sum(int((s.out.terminated | s.out.truncated).sum())
               for s in traced)
    roof = _costs.roofline(costs, r["per_step_s"], done / (b * len(traced)))
    return 100.0 * roof["least_ms_per_step"] * 1e-3 / r["per_step_s"]
