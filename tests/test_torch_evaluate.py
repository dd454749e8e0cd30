"""The port's evaluator against the JAX package's on one scripted fake env:
a recorded numpy stream of step outputs with staggered episode ends (some
envs end twice, some never), indexed by a step counter kept in the env
state. Both evaluators take their env as arguments, so both replay the same
stream; the reward also depends on the policy's action, which depends on the
frame stack, so the stack handling is part of what is compared.

All nine metrics and the per-case ones agree within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.env.batched import StepOutput as JStepOutput
from torchdriveenv_tpu.models.policies import scale_action as jscale
from torchdriveenv_tpu.rl.evaluate import make_evaluator as jmake
from torchdriveenv_tpu_torch.env.batched import StepOutput as TStepOutput
from torchdriveenv_tpu_torch.models.policies import scale_action as tscale
from torchdriveenv_tpu_torch.rl.evaluate import make_evaluator as tmake

torch.set_num_threads(2)
E, T, N_CASES, FS = 7, 12, 3, 3
NINE = ("mean_episode_reward", "mean_episode_length", "offroad_rate",
        "collision_rate", "traffic_light_violation_rate",
        "success_percentage", "reached_waypoint_num", "psi_smoothness",
        "speed_smoothness")
INFO_F32 = ("offroad", "collision", "traffic_light_violation",
            "psi_smoothness", "speed_smoothness")


def _stream(seed=0):
    rng = np.random.default_rng(seed)
    # first episode end per env: steps 2, 3, 5, 6, 8, 12 (truncated at the
    # horizon) and never; later ends (second episodes) must be ignored
    first_end = np.array([2, 3, 5, 6, 8, 12, 99])
    kind = np.array(["offroad", "collision", "light", "trunc", "collision",
                     "trunc", "none"])
    term = np.zeros((T, E), bool)
    trunc = np.zeros((T, E), bool)
    info = {k: np.zeros((T, E), np.float32) for k in INFO_F32}
    info["psi_smoothness"] = rng.random((T, E)).astype(np.float32)
    info["speed_smoothness"] = rng.random((T, E)).astype(np.float32) * 3
    success = np.zeros((T, E), bool)
    for e in range(E):
        t = first_end[e] - 1
        if t < T:
            if kind[e] == "trunc":
                trunc[t, e] = success[t, e] = True
            else:
                term[t, e] = True
                key = {"light": "traffic_light_violation"}.get(kind[e], kind[e])
                info[key][t, e] = 1.0
        # a second episode that ends in every way at once, later
        if t + 2 < T:
            term[t + 2, e] = trunc[t + 2, e] = success[t + 2, e] = True
            for k in ("offroad", "collision", "traffic_light_violation"):
                info[k][t + 2, e] = 1.0
    info["is_success"] = success
    info["reached_waypoint_num"] = np.cumsum(
        rng.integers(0, 2, (T, E)), axis=0).astype(np.int32)
    return dict(
        obs=rng.integers(0, 256, (T + 1, E, 3, 4, 4), dtype=np.uint8),
        reward=rng.normal(size=(T, E)).astype(np.float32),
        terminated=term, truncated=trunc, info=info)


CASES = np.array([0, 1, 2, 0, 1, 0, 0], np.int32)      # case 2 runs once


def _jax_metrics(stream, cases):
    rec = jax.tree.map(jnp.asarray, stream)

    def reset_fn(keys, case=None):
        return jnp.zeros((), jnp.int32), rec["obs"][0]

    def step_fn(t, action):
        return JStepOutput(
            state=t + 1, obs=rec["obs"][t + 1],
            reward=rec["reward"][t] + action[:, 0],
            terminated=rec["terminated"][t], truncated=rec["truncated"][t],
            info={k: v[t] for k, v in rec["info"].items()})

    def policy(_, stack):
        m = stack.astype(jnp.float32).mean(axis=(2, 3)) / 255.0    # (E, 9)
        return jnp.tanh(jnp.stack([m[:, 0] - m[:, -1], m[:, 4] - 0.5], -1))

    kw = {} if cases is None else dict(cases=cases, n_cases=N_CASES)
    ev = jmake(reset_fn, step_fn, policy, FS, jscale, max_steps=T, **kw)
    keys = jax.random.split(jax.random.PRNGKey(0), E)
    return {k: float(v) for k, v in ev(keys, None).items()}


def _torch_metrics(stream, cases):
    rec = {k: torch.from_numpy(v) for k, v in stream.items() if k != "info"}
    rec_info = {k: torch.from_numpy(v) for k, v in stream["info"].items()}
    seen = {}

    def reset_fn(generator, num_envs, case):
        seen["cases"] = case
        assert num_envs == E
        return 0, rec["obs"][0]

    def step_fn(t, action, generator):
        return TStepOutput(
            state=t + 1, obs=rec["obs"][t + 1],
            reward=rec["reward"][t] + action[:, 0],
            terminated=rec["terminated"][t], truncated=rec["truncated"][t],
            info={k: v[t] for k, v in rec_info.items()})

    def policy(_, stack):
        m = stack.to(torch.float32).mean(dim=(2, 3)) / 255.0
        return torch.tanh(torch.stack([m[:, 0] - m[:, -1], m[:, 4] - 0.5], -1))

    kw = {} if cases is None else dict(cases=cases, n_cases=N_CASES)
    ev = tmake(reset_fn, step_fn, policy, FS, tscale, max_steps=T, **kw)
    out = ev(torch.Generator().manual_seed(0), E, None)
    if cases is None:
        assert seen["cases"] is None
    else:
        assert seen["cases"].tolist() == list(cases)
    assert all(v.dim() == 0 and not v.requires_grad for v in out.values())
    return {k: float(v) for k, v in out.items()}


@pytest.mark.parametrize("with_cases", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed, with_cases):
    stream = _stream(seed)
    cases = CASES if with_cases else None
    got, want = _torch_metrics(stream, cases), _jax_metrics(stream, cases)
    names = list(NINE)
    if with_cases:
        names += [f"{m}_case_{i}" for i in range(N_CASES)
                  for m in ("success", "reached")]
    assert sorted(got) == sorted(want) == sorted(names)
    for k in names:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k


def test_accumulators_freeze_at_the_first_episode_end():
    """The stream's numbers, by hand: lengths are the first ends, each env
    counts its own first infraction only, and two envs succeed."""
    got = _torch_metrics(_stream(0), CASES)
    lengths = [2, 3, 5, 6, 8, 12, 12]
    assert got["mean_episode_length"] == pytest.approx(np.mean(lengths))
    assert got["offroad_rate"] == pytest.approx(1 / E)
    assert got["collision_rate"] == pytest.approx(2 / E)
    assert got["traffic_light_violation_rate"] == pytest.approx(1 / E)
    assert got["success_percentage"] == pytest.approx(2 / E)
    # per case: case 0 holds envs 0, 3, 5, 6 (two truncate), case 1 envs 1, 4
    assert got["success_case_0"] == pytest.approx(2 / 4)
    assert got["success_case_1"] == 0.0 and got["success_case_2"] == 0.0
    stream = _stream(0)
    reached = stream["info"]["reached_waypoint_num"]
    want = np.mean([reached[min(n, T) - 1, e] for e, n in enumerate(lengths)])
    assert got["reached_waypoint_num"] == pytest.approx(want)
