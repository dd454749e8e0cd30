"""The port's fused train steps on the CPU.

Off-policy (8 envs, a 64-cell ring, batches of 16), for SAC and TD3: the
properties the JAX package's own tests hold for its train step
(``tests/test_rl.py``: ``TestLearningStarts``, ``TestDemoWarmup``): warmup
skips updates, then the parameters move; the demo phase flags its rows and
feeds the buffer; ``demo_envs`` keeps the first K envs scripted; and the
buffer's bookkeeping and stored frames are right.

On-policy, against the JAX package's own train step on the real env: both
sides start from JAX's reset states and weights, the port is handed the
actions' noise, the states JAX's auto-reset drew and the update's
permutations, and the rollouts must agree: ``obs`` and ``done`` exactly;
``action``, ``log_prob``, ``value`` and the bootstrapped ``reward`` within
1e-5; then the metrics and the updated agent at the tolerance of
``tests/test_torch_ppo.py``. Every env is truncated inside the rollout.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.maps.arrays import load_assets
from torchdriveenv_tpu_torch.models.policies import scale_action, unscale_action
from torchdriveenv_tpu_torch.parallel.train_step import (
    OffPolicyCarry,
    make_offpolicy_train_fns,
)
from torchdriveenv_tpu_torch.rl.demo import make_scripted_driver
from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig

torch.set_num_threads(2)
E, CAP, BATCH, SPI, UPI = 8, 64, 16, 2, 2


@pytest.fixture(scope="module")
def assets():
    return load_assets("val", device="cpu")


def _fns(assets, demo=False, **kw):
    cfg = EnvConfig()
    sac_kw = kw.pop("sac", {})
    agent = SAC(SACConfig(batch_size=BATCH, **sac_kw),
                compute_dtype=torch.float32)
    demo_fn = make_scripted_driver(cfg, assets) if demo else None
    init_fn, step_fn = make_offpolicy_train_fns(
        cfg, agent, E, buffer_capacity=CAP, steps_per_iter=SPI,
        updates_per_iter=UPI, demo_fn=demo_fn, device="cpu", **kw)
    return cfg, agent, init_fn, step_fn


def _params(agent):
    st = agent.state
    return copy.deepcopy((st.actor.state_dict(), st.critic.state_dict(),
                          st.target_critic.state_dict(),
                          st.log_alpha.detach().clone()))


def _same(a, b):
    return all(torch.equal(x[k], y[k]) for x, y in zip(a[:3], b[:3])
               for k in x) and torch.equal(a[3], b[3])


def test_warmup_skips_updates_then_learns(assets):
    """Until env_steps >= learning_starts, actions are uniform draws and no
    gradient update runs; the metrics are zeros."""
    _, agent, init_fn, step_fn = _fns(assets, sac=dict(learning_starts=2 * E * SPI))
    carry = init_fn(assets, seed=0)
    assert isinstance(carry, OffPolicyCarry) and carry.env_steps == 0
    assert carry.rollout.obs_stack.shape == (E, 9, 64, 64)
    p0 = _params(agent)
    for it in (1, 2):       # env_steps 0 and 16 at entry: both below 32
        carry, m = step_fn(assets, carry)
        assert _same(_params(agent), p0), f"warmup step {it}"
        assert agent.state.step == 0
        assert sorted(m) == sorted(SAC.metric_names + ("mean_step_reward",))
        for k in SAC.metric_names:
            assert float(m[k]) == 0.0, k
        assert torch.isfinite(m["mean_step_reward"])
    # warmup actions are uniform in (-1, 1): not a policy's, not clipped
    acts = carry.buffer.action[:, :2 * SPI]
    assert (acts.abs() < 1.0).all() and acts.std() > 0.3
    carry, m = step_fn(assets, carry)       # env_steps 32 at entry: learning
    assert agent.state.step == UPI
    assert not _same(_params(agent), p0)
    for k, v in m.items():
        assert torch.isfinite(v), k
    assert float(m["critic_loss"]) > 0.0 and float(m["alpha"]) > 0.0
    assert carry.agent_state is agent.state


def test_warmup_is_decided_once_per_train_step(assets):
    """learning_starts falls inside the first train step: the whole step is
    still warmup (the test is made before the env steps)."""
    _, agent, init_fn, step_fn = _fns(assets, sac=dict(learning_starts=E))
    carry = init_fn(assets, seed=1)
    carry, m = step_fn(assets, carry)       # 0 < 8 at entry, 16 after
    assert agent.state.step == 0 and float(m["critic_loss"]) == 0.0
    carry, m = step_fn(assets, carry)
    assert agent.state.step == UPI and float(m["critic_loss"]) > 0.0


def test_buffer_bookkeeping_and_stored_frames(assets):
    cfg, agent, init_fn, step_fn = _fns(assets, sac=dict(learning_starts=10**6))
    carry = init_fn(assets, seed=2)
    stacks = [carry.rollout.obs_stack.clone()]
    for it in range(1, 4):
        carry, _ = step_fn(assets, carry)
        stacks.append(carry.rollout.obs_stack.clone())
        assert carry.env_steps == it * SPI * E
        assert int(carry.buffer.pos) == int(carry.buffer.filled) == it * SPI
    buf = carry.buffer
    # the frame stored for a step is the newest frame of the stack the
    # action was computed from; cells 0, 2, 4 opened train steps 1, 2, 3
    for it in range(3):
        assert torch.equal(buf.frames[:, it * SPI], stacks[it][:, -3:])
    # the stack after a step that did not end the episode holds the stored
    # frames of the last cells, oldest first
    alive = ~buf.done[:, :6].any(1)
    assert alive.any()
    assert torch.equal(stacks[3][alive, 3:6], buf.frames[alive, 5])
    assert (buf.action[:, :6].abs() <= 1.0).all()
    assert not buf.is_demo.any()            # no demo_fn: nothing is flagged
    assert not buf.frames[:, 6:].any() and buf.frames[:, :6].any()


def test_buffer_ring_wraps(assets):
    cfg = EnvConfig()
    agent = SAC(SACConfig(batch_size=4, learning_starts=10**6),
                compute_dtype=torch.float32)
    init_fn, step_fn = make_offpolicy_train_fns(
        cfg, agent, 2, buffer_capacity=4, steps_per_iter=3, updates_per_iter=1,
        device="cpu")
    carry = init_fn(assets, seed=3)
    for _ in range(2):
        carry, _ = step_fn(assets, carry)
    assert int(carry.buffer.pos) == 6 and int(carry.buffer.filled) == 4


def test_demo_phase_feeds_buffer_and_learns(assets):
    """With demo_fn set, the demo phase replaces policy actions (warmup's
    random ones too) while updates still begin at learning_starts."""
    cfg, agent, init_fn, step_fn = _fns(
        assets, demo=True, demo_steps=2 * E * SPI,
        sac=dict(learning_starts=E * SPI, bc_coef=5.0))
    carry = init_fn(assets, seed=4)
    driver = make_scripted_driver(cfg, assets)
    want = torch.clamp(unscale_action(driver(carry.rollout.env_state)), -1, 1)
    carry, m = step_fn(assets, carry)       # warmup and demo phase
    assert float(m["critic_loss"]) == 0.0 and agent.state.step == 0
    # the first stored action is the scripted driver's, in normalized space
    assert torch.equal(carry.buffer.action[:, 0], want)
    p0 = _params(agent)
    carry, m = step_fn(assets, carry)       # demo phase, learning on
    assert not _same(_params(agent), p0)
    assert torch.isfinite(m["critic_loss"]) and float(m["critic_loss"]) > 0
    assert carry.buffer.is_demo[:, :2 * SPI].all()
    acts = carry.buffer.action[:, :2 * SPI]
    assert torch.isfinite(acts).all() and (acts.abs() <= 1.0).all()
    # env_steps reached demo_steps: from here on nothing is flagged
    carry, _ = step_fn(assets, carry)
    assert not carry.buffer.is_demo[:, 2 * SPI:].any()


def test_demo_envs_keeps_the_first_k_scripted(assets):
    cfg, agent, init_fn, step_fn = _fns(
        assets, demo=True, demo_steps=0, demo_envs=3,
        sac=dict(learning_starts=E * SPI))
    carry = init_fn(assets, seed=5)
    driver = make_scripted_driver(cfg, assets)
    for it in range(2):                     # warmup, then the policy acts
        state = carry.rollout.env_state
        want = torch.clamp(unscale_action(driver(state)), -1, 1)
        carry, _ = step_fn(assets, carry)
        cell = it * SPI
        assert torch.equal(carry.buffer.action[:3, cell], want[:3])
        assert not torch.equal(carry.buffer.action[3:, cell], want[3:])
    flags = carry.buffer.is_demo[:, :2 * SPI]
    assert flags[:3].all() and not flags[3:].any()
    # scripted actions reach the env inside its box
    box = scale_action(carry.buffer.action[:3, :2 * SPI])
    assert (box[..., 0].abs() <= 1.0).all() and (box[..., 1].abs() <= 0.3 + 1e-6).all()


def test_seed_fixes_the_run(assets):
    def run():
        _, agent, init_fn, step_fn = _fns(assets, sac=dict(learning_starts=E * SPI))
        carry = init_fn(assets, seed=7)
        for _ in range(2):
            carry, m = step_fn(assets, carry)
        return carry, m
    (c1, m1), (c2, m2) = run(), run()
    assert torch.equal(c1.buffer.frames, c2.buffer.frames)
    assert torch.equal(c1.buffer.action, c2.buffer.action)
    for k in m1:
        assert float(m1[k]) == float(m2[k]), k


def test_device_must_be_named_without_a_gpu(assets):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_offpolicy_train_fns(EnvConfig(), SAC(), E)


# ---------------------------------------------------------------------------
# the rollout module's collectors (rl/rollout.py)
# ---------------------------------------------------------------------------


def _env_fns(assets):
    from torchdriveenv_tpu_torch.env.batched import make_env_fns
    cfg = EnvConfig(max_environment_steps=3)        # episodes end in the run
    reset_fn, step_fn = make_env_fns(cfg, assets, with_final_obs=True)
    return cfg, reset_fn, step_fn


@pytest.mark.parametrize("random_action", [False, True])
def test_offpolicy_step_adds_what_it_stepped(assets, random_action):
    from torchdriveenv_tpu_torch.rl import buffer as replay
    from torchdriveenv_tpu_torch.rl.rollout import (
        RolloutState, init_stack, make_offpolicy_step)
    _, reset_fn, step_fn = _env_fns(assets)
    g = torch.Generator().manual_seed(0)
    state, obs = reset_fn(g, E)
    rs = RolloutState(state, init_stack(obs, 3))
    buf = replay.create(E, 16, (3, 64, 64), device="cpu")
    fixed = torch.tensor([[0.25, -0.5]]).repeat(E, 1)
    one = make_offpolicy_step(step_fn, lambda stack, gen: fixed, 3,
                              scale_action, replay.add)
    stacks = []
    for _ in range(4):
        stacks.append(rs.obs_stack)
        rs, buf, out = one(rs, buf, g, random_action=random_action)
    assert int(buf.pos) == 4
    for t in range(4):
        assert torch.equal(buf.frames[:, t], stacks[t][:, -3:])
    if random_action:
        assert (buf.action[:, :4].abs() < 1).all() and buf.action[:, :4].std() > 0.3
    else:
        assert torch.equal(buf.action[:, 0], fixed)
    # step 3 truncates every episode: the side ring holds the final frames,
    # and the stack restarts on the new episode's first frame
    assert buf.done[:, 2].all() and not buf.terminal[:, 2].all()
    trunc = buf.done[:, 2] & ~buf.terminal[:, 2]
    assert (buf.term_ptr[trunc] == 1).all()
    assert torch.equal(rs.obs_stack[:, :3], stacks[3][:, -3:])
    assert torch.equal(stacks[3][:, :3], stacks[3][:, 3:6])      # refilled


def test_collector_returns_time_major_rollouts(assets):
    from torchdriveenv_tpu_torch.rl.rollout import (
        RolloutState, init_stack, make_collector)
    _, reset_fn, step_fn = _env_fns(assets)
    g = torch.Generator().manual_seed(1)
    state, obs = reset_fn(g, E)
    rs = RolloutState(state, init_stack(obs, 3))

    def select_action(stack, gen):
        a = torch.rand(E, 2, generator=gen) * 2 - 1
        return a, -a.abs().sum(-1), stack.float().mean((1, 2, 3))

    collect = make_collector(step_fn, select_action, 3, scale_action)
    rs2, data = collect(rs, 5, g)
    assert data["obs"].shape == (5, E, 9, 64, 64)
    assert data["action"].shape == (5, E, 2)
    for k in ("log_prob", "value", "reward", "done"):
        assert data[k].shape == (5, E), k
    assert data["info"]["offroad"].shape == (5, E)
    assert torch.equal(data["obs"][0], rs.obs_stack)
    assert data["done"][2].all()                    # the 3-step horizon
    assert (rs2.env_state.step_idx == 2).all()      # 5 steps = 3 + 2
    assert torch.equal(data["value"][1],
                       data["obs"][1].float().mean((1, 2, 3)))


# ---------------------------------------------------------------------------
# TD3 through the same off-policy train step
# ---------------------------------------------------------------------------


def test_td3_warmup_skips_updates_then_learns(assets):
    from torchdriveenv_tpu_torch.rl.td3 import TD3, TD3Config
    agent = TD3(TD3Config(batch_size=BATCH, learning_starts=E * SPI),
                compute_dtype=torch.float32)
    init_fn, step_fn = make_offpolicy_train_fns(
        EnvConfig(), agent, E, buffer_capacity=CAP, steps_per_iter=SPI,
        updates_per_iter=4, device="cpu")
    carry = init_fn(assets, seed=0)
    before = copy.deepcopy(agent.export_state())
    carry, m = step_fn(assets, carry)           # env_steps 0 at entry: warmup
    assert sorted(m) == sorted(TD3.metric_names + ("mean_step_reward",))
    assert agent.state.step == 0
    assert all(float(m[k]) == 0.0 for k in TD3.metric_names)
    after = agent.export_state()
    assert all(torch.equal(before[n][k], after[n][k])
               for n in ("actor", "critic") for k in before[n])
    acts = carry.buffer.action[:, :SPI]         # uniform draws, not a policy's
    assert (acts.abs() < 1.0).all() and acts.std() > 0.3
    carry, m = step_fn(assets, carry)           # 16 >= learning_starts
    exported = agent.export_state()
    assert agent.state.step == 4 == exported["critic_opt"]["step"]
    assert exported["actor_opt"]["step"] == 2       # every second update
    for k, v in m.items():
        assert torch.isfinite(v), k
    assert float(m["critic_loss"]) > 0.0
    for n in ("actor", "target_actor", "critic", "target_critic"):
        assert any(not torch.equal(before[n][k], exported[n][k])
                   for k in before[n]), n
    # the policy acts now: tanh output plus clipped exploration noise
    acts = carry.buffer.action[:, SPI:2 * SPI]
    assert (acts.abs() <= 1.0).all()
    assert carry.agent_state is agent.state and carry.env_steps == 2 * E * SPI


# ---------------------------------------------------------------------------
# the on-policy train step against the JAX package's
# ---------------------------------------------------------------------------

ON_E, ON_T, ON_RES = 4, 5, 16


def _onpolicy_cfgs():
    from torchdriveenv_tpu.config import EnvConfig as JEnvConfig
    # 3-step episodes that only the time limit ends; exact (unpooled) resets
    kw = dict(ego_only=True, max_environment_steps=3, reset_pool=0,
              terminated_at_infraction=False)
    jcfg, tcfg = JEnvConfig(**kw), EnvConfig(**kw)
    jcfg.simulator.renderer.obs_res = ON_RES
    tcfg.simulator.renderer.obs_res = ON_RES
    return jcfg, tcfg


def _run_jax_onpolicy(algo):
    """One JAX train step -> (carry before, carry after, metrics, and what
    the port is handed: the keys of the actions' noise, the env states after
    each step's auto-reset, the rollout, last_value and the update's key).

    ``train_fn`` runs as the JAX package's own tests run it, un-jitted, so
    the spy on ``agent.update`` sees the rollout. The action keys follow
    ``train_step_fn``'s own splits. The auto-reset's states come from the
    same ``step_fn`` driven again with the rollout's actions."""
    from torchdriveenv_tpu.env import batched as jbatched
    from torchdriveenv_tpu.maps.arrays import load_assets as jload
    from torchdriveenv_tpu.models import policies as jpol
    from torchdriveenv_tpu.parallel import train_step as jts
    from torchdriveenv_tpu.rl import a2c as ja2c
    from torchdriveenv_tpu.rl import ppo as jppo
    jcfg, _ = _onpolicy_cfgs()
    jassets = jload("val")
    if algo == "ppo":
        agent = jppo.PPO(jppo.PPOConfig(n_steps=ON_T, batch_size=8, n_epochs=2))
    else:
        agent = ja2c.A2C(ja2c.A2CConfig(n_steps=ON_T))
    agent.net = jpol.GaussianActorCritic(compute_dtype=jnp.float32)
    seen = {}
    plain_update = jax.jit(agent.update)

    def update(state, rollout, last_value, key):
        seen.update(rollout=jax.tree.map(np.asarray, rollout),
                    last_value=np.asarray(last_value), key=key)
        return plain_update(state, rollout, last_value, key)

    agent.update = update
    init_fn, train_fn = jts.make_onpolicy_train_fns(jcfg, agent, ON_E)
    carry0 = jax.jit(init_fn)(jassets, jax.random.PRNGKey(0))
    carry1, metrics = train_fn(jassets, carry0)

    key, seen["act_keys"] = carry0.rollout.key, []
    for _ in range(ON_T):           # as train_step_fn's `one` splits them
        k_act, key = jax.random.split(key)
        seen["act_keys"].append(k_act)
    _, step_fn = jbatched.make_env_fns(jcfg, jassets, with_final_obs=True)
    step_fn = jax.jit(step_fn)
    state, seen["resets"] = carry0.rollout.env_state, []
    for t in range(ON_T):
        out = step_fn(state, jpol.scale_action(
            jnp.asarray(seen["rollout"]["action"][t])))
        np.testing.assert_array_equal(
            np.asarray(out.terminated | out.truncated),
            seen["rollout"]["done"][t])
        state = out.state
        seen["resets"].append(jax.tree.map(np.asarray, state))
    return agent, carry0, carry1, metrics, seen


def test_onpolicy_train_step_matches_jax(assets, monkeypatch, algo="ppo"):
    """PPO's train step (the step is the same for A2C, whose ``update`` is
    held to JAX's in ``tests/test_torch_a2c.py``; JAX compiles the env three
    times for this comparison, which is most of its minute)."""
    from test_torch_ppo import _perms, _tree_of, assert_states_close
    from torchdriveenv_tpu_torch.env import core as tcore
    from torchdriveenv_tpu_torch.models import convert
    from torchdriveenv_tpu_torch.parallel.train_step import (
        OnPolicyCarry, make_onpolicy_train_fns)
    from torchdriveenv_tpu_torch.rl.a2c import A2C, A2CConfig
    from torchdriveenv_tpu_torch.rl.ppo import PPO, PPOConfig
    from torchdriveenv_tpu_torch.rl.rollout import RolloutState

    jagent, jcarry0, jcarry1, jm, seen = _run_jax_onpolicy(algo)
    assert len(seen["act_keys"]) == len(seen["resets"]) == ON_T

    _, tcfg = _onpolicy_cfgs()
    if algo == "ppo":
        tagent = PPO(PPOConfig(n_steps=ON_T, batch_size=8, n_epochs=2),
                     compute_dtype=torch.float32)
    else:
        tagent = A2C(A2CConfig(n_steps=ON_T), compute_dtype=torch.float32)
    init_fn, train_fn = make_onpolicy_train_fns(tcfg, tagent, ON_E,
                                                device="cpu")
    carry = init_fn(assets, seed=0)
    assert isinstance(carry, OnPolicyCarry) and carry.env_steps == 0
    assert carry.rollout.obs_stack.shape == (ON_E, 9, ON_RES, ON_RES)
    # start where JAX started: its reset states, its stacks, its weights
    carry.rollout = RolloutState(
        tcore.EnvState.from_numpy(
            jax.tree.map(np.asarray, jcarry0.rollout.env_state), device="cpu"),
        torch.from_numpy(np.array(jcarry0.rollout.obs_stack)))
    tagent.load_state(convert.ppo_state_to_torch(
        _tree_of(jcarry0.agent_state), ON_RES))

    # hand over JAX's draws: the actions' noise, the states its auto-reset
    # drew (the port's own reset is held to JAX's in test_torch_core.py) and
    # the update's permutations
    noises = [torch.from_numpy(np.array(jax.random.normal(k, (ON_E, 2))))
              for k in seen["act_keys"]]
    fresh = [tcore.EnvState.from_numpy(s, device="cpu")
             for s in seen["resets"]]
    monkeypatch.setattr(tcore, "reset_from_draws",
                        lambda cfg, assets, draws: fresh.pop(0))
    plain_select, plain_update = tagent.select_action, tagent.update
    got = {}

    def select(obs, generator, noise=None):
        return plain_select(obs, noise=noises.pop(0))

    def update(rollout, last_value, generator=None, mesh=None):
        got.update(rollout=rollout, last_value=last_value)
        if algo == "ppo":
            return plain_update(rollout, last_value,
                                perms=_perms(seen["key"], 2, ON_T * ON_E))
        return plain_update(rollout, last_value, generator=generator)

    tagent.select_action, tagent.update = select, update
    carry, tm = train_fn(assets, carry)
    assert not noises and not fresh

    want, ro = seen["rollout"], got["rollout"]
    assert sorted(ro) == sorted(want)
    assert ro["obs"].shape == (ON_T, ON_E, 9, ON_RES, ON_RES)
    assert ro["obs"].dtype == torch.uint8 and ro["done"].dtype == torch.bool
    np.testing.assert_array_equal(ro["obs"].numpy(), want["obs"])
    np.testing.assert_array_equal(ro["done"].numpy(), want["done"])
    for k in ("action", "log_prob", "value", "reward", "raw_reward"):
        np.testing.assert_allclose(ro[k].numpy(), want[k], atol=1e-5,
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["last_value"].numpy(), seen["last_value"],
                               atol=1e-5)
    # every env ran into the 3-step limit at rows 2 (and the next episode
    # has not ended by row 4); exactly those rows carry the bootstrap
    assert want["done"][2].all() and not want["done"][[0, 1, 3, 4]].any()
    boosted = (ro["reward"] - ro["raw_reward"]).numpy()
    assert (boosted[2] != 0.0).all() and (boosted[[0, 1, 3, 4]] == 0.0).all()
    # the stack after a truncation restarts on the new episode's first frame
    assert torch.equal(ro["obs"][3][:, :3], ro["obs"][3][:, 6:])
    np.testing.assert_array_equal(carry.rollout.obs_stack.numpy(),
                                  np.asarray(jcarry1.rollout.obs_stack))

    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert float(tm["mean_step_reward"]) == pytest.approx(
        float(want["raw_reward"].mean()), abs=1e-6)
    assert_states_close(tagent, jcarry1.agent_state, "after the train step",
                        res=ON_RES)
    assert carry.env_steps == ON_T * ON_E == int(jcarry1.env_steps)
    assert carry.agent_state is tagent.state


@pytest.mark.parametrize("algo", ["ppo", "a2c"])
def test_onpolicy_train_step_runs_on_its_own_draws(assets, algo):
    """Without anything handed over: pooled resets, the generator's noise
    and permutations; two runs from one seed agree bit for bit."""
    from torchdriveenv_tpu_torch.parallel.train_step import make_onpolicy_train_fns
    from torchdriveenv_tpu_torch.rl.a2c import A2C, A2CConfig
    from torchdriveenv_tpu_torch.rl.ppo import PPO, PPOConfig

    def run():
        cfg = EnvConfig(ego_only=True, max_environment_steps=3, reset_pool=2)
        cfg.simulator.renderer.obs_res = ON_RES
        if algo == "ppo":
            agent = PPO(PPOConfig(n_steps=4, batch_size=8, n_epochs=1),
                        compute_dtype=torch.float32)
        else:
            agent = A2C(A2CConfig(n_steps=4), compute_dtype=torch.float32)
        init_fn, train_fn = make_onpolicy_train_fns(cfg, agent, ON_E,
                                                    device="cpu")
        carry = init_fn(assets, seed=3)
        for _ in range(2):
            carry, m = train_fn(assets, carry)
        return carry, m, agent

    (c1, m1, a1), (c2, m2, a2) = run(), run()
    assert c1.env_steps == 2 * 4 * ON_E and a1.state.step == 2
    assert sorted(m1) == sorted(PPO.metric_names + ("mean_step_reward",))
    for k in m1:
        assert torch.isfinite(m1[k]) and float(m1[k]) == float(m2[k]), k
    assert torch.equal(c1.rollout.obs_stack, c2.rollout.obs_stack)
    for p, q in zip(a1.state.net.parameters(), a2.state.net.parameters()):
        assert torch.equal(p, q)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_onpolicy_train_fns(EnvConfig(), PPO(), ON_E)


def test_small_constants_are_built_once_per_device(assets):
    """The action bounds and the spawn grid are uploaded once and reused:
    building a tensor from host data at every env step is a copy that
    synchronizes the host with a GPU (seen with
    ``torch.cuda.set_sync_debug_mode`` on the card: five per env step)."""
    from torchdriveenv_tpu_torch.maps.arrays import device_constant
    from torchdriveenv_tpu_torch.parallel.train_step import make_onpolicy_train_fns
    from torchdriveenv_tpu_torch.rl.a2c import A2C, A2CConfig
    cpu = torch.device("cpu")
    a = device_constant((1.0, -0.3), cpu)
    assert a is device_constant((1.0, -0.3), cpu) and a.dtype == torch.float32
    assert device_constant((1, 2), cpu, torch.int32).tolist() == [1, 2]
    cfg = EnvConfig(max_environment_steps=3)
    agent = A2C(A2CConfig(n_steps=2), compute_dtype=torch.float32)
    init_fn, train_fn = make_onpolicy_train_fns(cfg, agent, 4, device="cpu")
    carry, _ = train_fn(assets, init_fn(assets, seed=0))
    before = device_constant.cache_info()
    train_fn(assets, carry)
    after = device_constant.cache_info()
    assert after.misses == before.misses            # nothing new was built
    assert after.hits >= before.hits + 2 * 5        # 2 env steps reused them
