"""The whole train step's share of the card's peaks: its least time over
the window's time per train step. The least time: per env step, physics,
two renders (the step's final frames and its new ones) and the auto-reset
x the share of envs done (the frozen ``_costs`` counts, at the f32 and HBM
peaks); per update, the SAC update's flops from the networks' shapes
(``_learner``), the bfloat16 torso at the bf16 peak and the f32 heads at
the f32 peak, or its bytes at the HBM rate, whichever is longer."""

from benchmark.metrics import _costs, _learner

MOVES = "train_step_device_ms"


def read(r):
    tt = r.get("traced_train")
    if tt is None:
        return None
    ref = r["ref"]
    cfg, assets, state = ref["cfg"], ref["assets"], tt.state
    costs = _costs.phase_costs(cfg, assets, state,
                               _costs.render_inputs(cfg, assets, state))
    scale = {"physics": 1.0, "render": 2.0,
             "autoreset_pool_all_done": tt.done_share}
    env = {k: sum(scale[p] * costs[p][k] for p in _costs.PHASES)
           for k in ("flops", "bytes")}
    env_s = _costs.least_s(env)[0]
    upd = _learner.sac_update_cost(r["actor_shapes"], r["critic_shapes"],
                                   r["batch_size"], r["obs_shape"])
    upd_s = max(upd["bf16_flops"] / _costs.H100_PEAK_BF16_FLOPS
                + upd["f32_flops"] / _costs.H100_PEAK_F32_FLOPS,
                upd["bytes"] / _costs.H100_PEAK_HBM_BYTES)
    least = (r["env_steps_per_train_step"] * env_s
             + r["updates_per_train_step"] * upd_s)
    return 100.0 * least / r["per_step_s"]
