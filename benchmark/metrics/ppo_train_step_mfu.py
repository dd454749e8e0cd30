"""The data-parallel PPO train step's share of the cards' peaks: its least
time over the window's time per train step. The least time, on each card:
per env step, physics, two renders (the step's final frames and its new
ones) and the auto-reset x the share of envs done (the program's counter
``envs_reset`` in the traced train step; the frozen ``_costs`` counts at
the f32 and HBM peaks) for the card's envs, and the rollout's two
forwards of them (the action's and the terminal stack's value); the last
value's forward; and the update's gradient steps at the global minibatch
split over the W cards (``_ppo_costs``), the bfloat16 torso at the bf16
peak and the f32 heads at the f32 peak, or its bytes at the HBM rate,
whichever is longer."""

from benchmark.metrics import _costs, _ppo_costs, _spans

MOVES = "env_steps_per_s"


def _at_peaks(cost: dict) -> float:
    return (cost["bf16_flops"] / _costs.H100_PEAK_BF16_FLOPS
            + cost["f32_flops"] / _costs.H100_PEAK_F32_FLOPS)


def read(r):
    state, log = r.get("traced_state"), _spans.log()
    if state is None or not log or "envs_reset" not in log[1]:
        return None
    ref = r["ref"]
    cfg, assets = ref["cfg"], ref["assets"]
    costs = _costs.phase_costs(cfg, assets, state,
                               _costs.render_inputs(cfg, assets, state))
    local = state.town.shape[0]
    steps = r["env_steps_per_train_step"] * r["trace_steps"]
    # the envs rank 0 reset in the traced train step (its counter
    # ``envs_reset``, the done mask of each env step), per env and step
    done_share = log[1]["envs_reset"] / (local * steps)
    scale = {"physics": 1.0, "render": 2.0,
             "autoreset_pool_all_done": done_share}
    env = {k: sum(scale[p] * costs[p][k] for p in _costs.PHASES)
           for k in ("flops", "bytes")}
    res = r["obs_shape"][1]
    shapes, algo, world = r["net_shapes"], r["algo"], r["world"]
    fwd = _at_peaks(_ppo_costs.rollout_forward_cost(shapes, local, res))
    steps = r["env_steps_per_train_step"]
    rows = steps * r["num_envs"]
    grad = _ppo_costs.gradient_step_cost(shapes, algo["batch_size"] // world,
                                         r["obs_shape"])
    grad_s = max(_at_peaks(grad), grad["bytes"] / _costs.H100_PEAK_HBM_BYTES)
    least = (steps * (_costs.least_s(env)[0] + 2 * fwd) + fwd
             + algo["n_epochs"] * (rows // algo["batch_size"]) * grad_s)
    return 100.0 * least / r["per_step_s"]
