"""PPO data parallel over four gloo ranks on the CPU against the
benchmark's plain reference (``benchmark/reference/ppo.py``), the spans and
counters of the sharded train step, and the faults across cards
(``benchmark/faults_cards.py``) failing the check of
``benchmark/drivers/onpolicy.py``.

Four ranks (``python tests/test_torch_ppo_w4.py <rank> <store>``, meeting
through ``init_method=file://<store>``) each take, on their rows of one
random rollout of 16 envs x 4 steps (frames of 20 px; the actions,
log-probs and values the policy's own, truncated envs' rewards
bootstrapped by the port), the port's ``PPO.update`` with minibatches of
16 and 2 epochs (8 gradient steps), learner in f32: once sound and once
with each fault of the update planted. Then one on-policy train step of 16
envs (4 a rank, a pool of 8) under ``spans.recording()``, and two pooled
env steps in which every env's episode ends, sound and with the pool's
offset left out. The test process takes the same update in one process,
and the reference's over the whole rollout: its recomputed values,
log-probs, bootstrap and GAE, and each gradient step from the program's
weights before it, held to the program at the Adam-parity tolerance of
``tests/test_torch_ppo.py``; the reference's own update ends on the
program's parameters likewise; the ranks are bit-equal.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import faults_cards  # noqa: E402
from benchmark.drivers import onpolicy  # noqa: E402
from benchmark.reference import ppo as rppo  # noqa: E402
from torchdriveenv_tpu_torch.parallel import mesh as pm  # noqa: E402
from torchdriveenv_tpu_torch.rl import ppo as tppo  # noqa: E402
from torchdriveenv_tpu_torch.utils import spans  # noqa: E402

N, T, RES, WORLD = 16, 4, 20, 4
ALGO = dict(n_steps=T, batch_size=16, n_epochs=2)
GRAD_STEPS = ALGO["n_epochs"] * T * N // ALGO["batch_size"]
WORKER_TIMEOUT_S = 150
ATOL, SCALE_RTOL = 2e-5, 1e-5        # tests/test_torch_ppo.py's Adam parity


def _agent():
    agent = tppo.PPO(tppo.PPOConfig(**ALGO), compute_dtype=torch.float32)
    agent.init(seed=1, obs_res=RES, device="cpu")
    return agent


def rollout(seed=5):
    """The global rollout (T, N) on random frames: the policy's own
    actions, log-probs and values; random raw rewards, terminations and
    truncations, each truncated (and not terminated) env's reward
    bootstrapped with the value of a random terminal stack by the port's
    ``bootstrap_truncated_rewards``; the last value of a random last stack.
    -> (rollout, last value, {terminated, truncated, final_at, final_obs,
    last_obs})."""
    g = torch.Generator().manual_seed(seed)
    agent = _agent()

    def frames(*lead):
        return torch.randint(0, 256, lead + (9, RES, RES), generator=g,
                             dtype=torch.uint8)
    obs = frames(T, N)
    a, logp, value = agent.select_action(obs.reshape((T * N, 9, RES, RES)),
                                         g)
    raw = torch.randn((T, N), generator=g)
    terminated = torch.rand((T, N), generator=g) < 0.15
    truncated = torch.rand((T, N), generator=g) < 0.15
    final_at = torch.nonzero(truncated)
    final_obs = frames(final_at.shape[0])
    v_final = torch.zeros(T, N)
    v_final[final_at[:, 0], final_at[:, 1]] = agent.value(final_obs)
    last_obs = frames(N)
    roll = dict(obs=obs, action=a.reshape(T, N, 2),
                log_prob=logp.reshape(T, N), value=value.reshape(T, N),
                reward=tppo.bootstrap_truncated_rewards(
                    raw, terminated, truncated, v_final, tppo.PPOConfig.gamma),
                done=terminated | truncated, raw_reward=raw)
    return roll, agent.value(last_obs), dict(
        terminated=terminated, truncated=truncated, final_at=final_at,
        final_obs=final_obs, last_obs=last_obs)


def take_update(mesh, fault=None) -> dict:
    """The port's update of a fresh agent on this process's rows, watched
    as the driver watches it -> {parts (each step's global loss parts),
    grads, after (each step's clipped gradient and weights after it),
    adam (its state before), advantages, returns (this process's rows),
    weights, gen_state}."""
    roll, last, _ = rollout()
    if mesh is not None:
        roll = {k: v[:, mesh.lo:mesh.hi] for k, v in roll.items()}
        last = last[mesh.lo:mesh.hi]
    agent = _agent()
    unplant = fault(agent, mesh) if fault is not None else None
    probe = onpolicy.Probe(agent, mesh)
    with probe.watching(tppo):
        agent.update(roll, last, generator=torch.Generator().manual_seed(11),
                     mesh=mesh)
    if unplant is not None:
        unplant()
    parts = torch.stack(probe.parts).reshape(-1, 3)
    if mesh is not None:
        torch.distributed.all_reduce(parts)
    return dict(parts=parts, grads=probe.grads, after=probe.after,
                adam=probe.adam, advantages=probe.gae[0],
                returns=probe.gae[1],
                weights={n: p.detach().clone()
                         for n, p in agent.state.net.named_parameters()},
                gen_state=probe.update_in["gen_state"])


def train_step_spans(mesh) -> dict:
    """One on-policy train step of N envs under ``spans.recording()`` ->
    {span name: count, counters, the net's parameter count}."""
    from torchdriveenv_tpu_torch.config import construct_env_config
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.parallel.train_step import (
        make_onpolicy_train_fns,
    )
    cfg = construct_env_config(dict(
        ego_only=True, max_environment_steps=5, reset_pool=8,
        simulator=dict(renderer=dict(obs_res=RES))))
    agent = _agent()
    assets = load_assets("val", device="cpu")
    init_fn, step = make_onpolicy_train_fns(cfg, agent, N, device="cpu",
                                            mesh=mesh)
    carry = init_fn(assets, 3)
    spans.clear()
    with spans.recording():
        step(assets, carry)
    names = {}
    for r in spans.records():
        names[r["name"]] = names.get(r["name"], 0) + 1
    out = dict(names=names, counters=spans.counters(),
               params=sum(p.numel() for p in agent.state.net.parameters()))
    spans.clear()
    return out


def pooled_steps(mesh, fault=None):
    """Two env steps of N envs from a first reset, every env's episode
    over at the second (a pool of 8 for the resets) -> the global state after them
    (rank 0; None on the other ranks)."""
    from torchdriveenv_tpu_torch.config import construct_env_config
    from torchdriveenv_tpu_torch.env.batched import make_env_fns
    from torchdriveenv_tpu_torch.maps.arrays import load_assets
    from torchdriveenv_tpu_torch.parallel.train_step import _first_reset
    cfg = construct_env_config(dict(
        ego_only=True, max_environment_steps=2, reset_pool=8,
        simulator=dict(renderer=dict(obs_res=RES))))
    assets = load_assets("val", device="cpu")
    unplant = fault(None, mesh) if fault is not None else None
    try:
        g, state, _ = _first_reset(cfg, assets, N, 3, mesh)
        step = make_env_fns(cfg, assets, render=True, mesh=mesh)[1]
        local = N if mesh is None else mesh.local_envs
        for _ in range(2):
            out = step(state, torch.full((local, 2), 0.1), g)
            state = out.state
        assert bool((out.terminated | out.truncated).all())
    finally:
        if unplant is not None:
            unplant()
    return onpolicy.tree_to_rank0(state, mesh)


def worker(rank, store):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    assert pm.maybe_init_distributed(backend="gloo",
                                     init_method=f"file://{store}",
                                     timeout_s=90)
    try:
        mesh = pm.make_mesh(N)
        out = {"sound": take_update(mesh)}
        for name, fault in faults_cards.UPDATE_FAULTS.items():
            out[name] = take_update(mesh, fault)
        out["spans"] = train_step_spans(mesh)
        out["pooled"] = pooled_steps(mesh)
        out["pooled_offset_left_out"] = pooled_steps(
            mesh, faults_cards.reset_offset_left_out)
        torch.save(out, f"{store}.rank{rank}")
    finally:
        torch.distributed.destroy_process_group()


def spawn(tmp_path, attempts=2):
    """The four ranks -> each rank's results. A run whose ranks never met
    (gloo's TCP set-up failed before any code under test ran) is started
    once more in a fresh directory."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else [])))
    for attempt in range(attempts):
        run_dir = tmp_path / f"ranks{attempt}"
        run_dir.mkdir()
        store = str(run_dir / "store")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), store],
            env=env, cwd=str(run_dir), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        failed = [(r, p.returncode, out)
                  for r, (p, out) in enumerate(zip(procs, outs))
                  if p.returncode]
        if not failed:
            return [torch.load(f"{store}.rank{r}", weights_only=False)
                    for r in range(WORLD)]
        if not all("connectFullMesh failed" in out for _, _, out in failed):
            break
    raise AssertionError("\n".join(f"rank {r} exited {rc}:\n{out[-3000:]}"
                                    for r, rc, out in failed))


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2])
    sys.exit(0)


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------

import pytest  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn(tmp_path_factory.mktemp("ppo_w4"))


@pytest.fixture(scope="module")
def reference():
    """The reference's own update of the rollout, from the same weights."""
    roll, _, _ = rollout()
    weights = {n: p.detach().clone()
               for n, p in _agent().state.net.named_parameters()}
    net = rppo.network(weights, "cpu", obs_res=RES,
                       compute_dtype=torch.float32)
    gen_state = torch.Generator().manual_seed(11).get_state()
    rppo.update(rppo.PPOConfig(**ALGO), net, None, roll["obs"],
                roll["action"], roll["log_prob"], *rppo.gae(
                    roll["reward"], roll["value"], roll["done"],
                    rollout()[1], tppo.PPOConfig.gamma,
                    tppo.PPOConfig.gae_lambda), gen_state, "cpu")
    return {"before": weights,
            "weights": {n: p.detach().clone()
                        for n, p in net.named_parameters()}}


def _readings(case: dict, advantages, returns, before) -> dict:
    """The check's update readings of the program's ``case`` (its
    advantages and returns joined over the ranks) against the reference
    taken from the same weights before each step."""
    roll, last, extra = rollout()
    cfg = rppo.PPOConfig(**ALGO)
    names = list(before)
    prog = onpolicy._program_side(
        SimpleNamespace(grads=case["grads"], after=case["after"]), names,
        before, roll, last, advantages, returns, case["parts"], cfg)
    net = rppo.network(before, "cpu", obs_res=RES,
                       compute_dtype=torch.float32)
    ref = rppo.rollout(cfg, net, roll["obs"], roll["action"],
                       roll["raw_reward"], extra["terminated"],
                       extra["truncated"], extra["final_at"],
                       extra["final_obs"], extra["last_obs"])
    ref["advantages"], ref["returns"] = rppo.gae(
        ref["reward"], ref["value"], roll["done"], ref["last_value"],
        cfg.gamma, cfg.gae_lambda)
    ref.update(rppo.update(cfg, net, case["adam"], roll["obs"],
                           roll["action"], roll["log_prob"], advantages,
                           returns, case["gen_state"], "cpu",
                           forced=prog["forced"]))
    return onpolicy.update_readings(prog, ref)


def _four_rank_readings(ranks, case, reference):
    """The check's update readings of a four-rank case, and ``rank_gap``."""
    out = _readings(ranks[0][case], _global(ranks, case, "advantages"),
                    _global(ranks, case, "returns"), reference["before"])
    first = ranks[0][case]["weights"]
    out["rank_gap"] = max(float((r[case]["weights"][n] - w).abs().max())
                          for r in ranks for n, w in first.items())
    return out


def _global(ranks, case, key):
    """A (T, local) tensor of every rank, joined along the env axis."""
    return torch.cat([r[case][key] for r in ranks], dim=1)


def _assert_close(got, want, name):
    diff = (got - want).abs()
    tol = ATOL + SCALE_RTOL * float(want.abs().max())
    assert float(diff.max()) <= tol, (
        f"{name}: max difference {float(diff.max()):.3g} over {tol:.3g}")


def _assert_matches(case: dict, reference: dict, readings: dict):
    assert readings["rollout_gap"] <= 1e-5, readings
    assert readings["adv_gap"] <= 1e-5, readings
    assert readings["pg_loss_gap"] <= 1e-4, readings
    assert readings["v_loss_gap"] <= 1e-4, readings
    assert readings["grad_gap"] <= 1e-4, readings
    assert readings["change_gap"] <= 1e-3, readings
    assert len(case["grads"]) == len(case["after"]) == GRAD_STEPS
    for n, w in reference["weights"].items():
        _assert_close(case["weights"][n], w, n)


def test_reference_matches_one_process(reference):
    case = take_update(None)
    readings = _readings(case, case["advantages"], case["returns"],
                         reference["before"])
    _assert_matches(case, reference, readings)


def test_reference_matches_four_ranks(ranks, reference):
    readings = _four_rank_readings(ranks, "sound", reference)
    _assert_matches(ranks[0]["sound"], reference, readings)
    # every rank bit-equal to rank 0, the permutations' generator alike
    assert readings["rank_gap"] == 0.0
    for r in ranks[1:]:
        assert torch.equal(r["sound"]["gen_state"],
                           ranks[0]["sound"]["gen_state"])


@pytest.mark.parametrize("fault", sorted(faults_cards.UPDATE_FAULTS))
def test_fault_fails_the_check(ranks, reference, fault):
    from benchmark import manifest
    limits = manifest.config(manifest.load_manifest(), "ppo_16k")["check"]
    readings = _four_rank_readings(ranks, fault, reference)
    assert any(readings[k] > limits[k] for k in readings), readings


def _leaves(state) -> list:
    out = []
    pm.map_tensors(lambda x: out.append(x) or x, state)
    return out


def test_pooled_reset_offset_across_ranks(ranks):
    """The pooled reset over four ranks gives the one-process state; with
    the exchange of offsets left out, ranks reuse the pool's first entries
    and the state parts from it."""
    alone = _leaves(pooled_steps(None))
    sound = _leaves(ranks[0]["pooled"])
    assert all(torch.equal(a, b) for a, b in zip(alone, sound))
    faulty = _leaves(ranks[0]["pooled_offset_left_out"])
    assert not all(torch.equal(a, b) for a, b in zip(alone, faulty))


def test_sharded_train_step_spans_and_counters(ranks):
    got = ranks[0]["spans"]
    names, counters = got["names"], got["counters"]
    for name in ("train.step", "train.env", "train.update", "ppo.gae"):
        assert names[name] == 1, names
    assert names["ppo.grad_step"] == names["ppo.owned_rows"] == GRAD_STEPS
    # three a gradient step (the advantages' two sums, the gradients), one
    # a pooled reset (where this rank's share of the pool starts), the
    # update's metrics and the mean reward
    collectives = 3 * GRAD_STEPS + T + 2
    assert names["mesh.collective"] == collectives, names
    assert counters["mesh.collectives"] == collectives, counters
    assert counters["mesh.collective_bytes"] == (
        GRAD_STEPS * (4 + 4 + 4 * got["params"]) + T * 8 * WORLD + 16 + 4)
    for r in ranks[1:]:        # every rank issues the same collectives
        assert r["spans"]["counters"]["mesh.collectives"] == collectives


def test_one_process_train_step_issues_no_collective():
    got = train_step_spans(None)
    names, counters = got["names"], got["counters"]
    assert names["train.step"] == names["train.update"] == 1
    assert names["ppo.grad_step"] == GRAD_STEPS
    assert "ppo.owned_rows" not in names and "mesh.collective" not in names
    assert "mesh.collectives" not in counters
    assert "mesh.collective_bytes" not in counters
