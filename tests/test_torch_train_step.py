"""The port's fused off-policy train step on the CPU (8 envs, a 64-cell
ring, batches of 16). The JAX train step builds its env inside and draws
resets from its own keys, so the two cannot be fed one stream; this file
holds the properties the JAX package's own tests hold for it
(``tests/test_rl.py``: ``TestLearningStarts``, ``TestDemoWarmup``): warmup
skips updates, then the parameters move; the demo phase flags its rows and
feeds the buffer; ``demo_envs`` keeps the first K envs scripted; and the
buffer's bookkeeping and stored frames are right.
"""

import copy

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
