"""``models/convert.py`` on the committed SAC deliverable: the Orbax
checkpoint is restored with orbax here, carried across, and the port's actor
must act like the JAX package's (deterministic actions at f32, atol 1e-4).
The shipped ``.npz`` must be that conversion, bit for bit, both directions
must round-trip exactly, and a whole ``SACState`` must carry its optax Adam
states into ``torch.optim.Adam``'s. So must a ``PPOState`` / ``A2CState``,
whose Adam state sits behind the clip of an ``optax.chain``, and a
``TD3State``, live and as a checkpoint restores them.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from tools import export_torch_actor
from torchdriveenv_tpu.models import policies as jpol
from torchdriveenv_tpu_torch import models as tmodels
from torchdriveenv_tpu_torch.config import EnvConfig as TEnvConfig
from torchdriveenv_tpu_torch.env.batched import BatchedEnv
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.models import convert
from torchdriveenv_tpu_torch.models import policies as tpol
from torchdriveenv_tpu_torch.rl import rollout as trollout
from torchdriveenv_tpu_torch.rl.sac import SAC, SACConfig

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "artifacts", "deliverable_sac_stage1_model_2000384")


@pytest.fixture(scope="module")
def tree():
    return ocp.PyTreeCheckpointer().restore(CKPT)


@pytest.fixture(scope="module")
def rendered_stacks():
    """32 frame stacks of the validation suite after a few steps."""
    env = BatchedEnv(TEnvConfig(), tload("val", device="cpu"), 32,
                     device="cpu", seed=0)
    state, obs = env.reset()
    stack = trollout.init_stack(obs, 3)
    act = torch.tensor([[0.5, 0.02]]).repeat(32, 1)
    for _ in range(4):
        out = env.step(state, act)
        state = out.state
        stack = trollout.update_stack(stack, out.obs,
                                      out.terminated | out.truncated)
    return stack.numpy()


def _jax_actions(tree, obs):
    actor = jpol.SquashedGaussianActor(compute_dtype=jnp.float32)
    mu, _ = actor.apply(tree["actor_params"], jnp.asarray(obs))
    return np.asarray(jnp.tanh(mu))


@pytest.mark.parametrize("kind", ["rendered", "random"])
def test_deliverable_actor_acts_like_the_jax_actor(tree, rendered_stacks, kind):
    obs = rendered_stacks if kind == "rendered" else np.random.default_rng(
        0).integers(0, 256, (32, 9, 64, 64), dtype=np.uint8)
    actor = tpol.SquashedGaussianActor(compute_dtype=torch.float32)
    actor.load_state_dict(convert.params_to_torch(tree["actor_params"], 64))
    with torch.no_grad():
        mu, _ = actor.eval()(torch.from_numpy(obs))
    got = torch.tanh(mu).numpy()
    want = _jax_actions(tree, obs)
    assert np.ptp(want, axis=0).min() > 1e-3, "the inputs tell actions apart"
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_loaded_actor_is_the_deliverable(tree, rendered_stacks):
    actor = tmodels.load_actor(device="cpu", compute_dtype=torch.float32)
    assert not actor.training
    with torch.no_grad():
        mu, _ = actor(torch.from_numpy(rendered_stacks))
    np.testing.assert_allclose(torch.tanh(mu).numpy(),
                               _jax_actions(tree, rendered_stacks),
                               atol=1e-4, rtol=0)
    # the default is the JAX package's default: a bf16 torso
    assert tmodels.load_actor(device="cpu").torso.compute_dtype == torch.bfloat16


def test_load_actor_needs_a_device_by_name():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.load_actor()


def test_committed_npz_is_the_conversion_of_the_checkpoint(tree):
    want = export_torch_actor.actor_arrays(tree, obs_res=64, frame_stack=3)
    with np.load(tmodels.DELIVERABLE_ACTOR) as z:
        assert sorted(z.files) == sorted(want)
        for k in z.files:
            assert z[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
        assert int(z["obs_res"]) == 64 and int(z["frame_stack"]) == 3
        assert z["torso.conv1.weight"].shape == (32, 9, 8, 8)
        assert z["torso.fc.weight"].shape == (512, 1024)
        assert z["latent.weight"].shape == (256, 512)


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("which", ["actor_params", "critic_params"])
def test_params_round_trip_is_exact(tree, which):
    state = convert.params_to_torch(tree[which], 64)
    back = convert.params_from_torch(state, 64)
    _assert_trees_equal(back, tree[which])
    again = convert.params_to_torch(back, 64)
    assert sorted(again) == sorted(state)
    for k in state:
        assert torch.equal(again[k], state[k]), k


def test_fc_rows_are_permuted_for_the_nchw_flatten():
    """A torso whose fc reads one (h, w, c) cell must read the same cell
    after the conversion: row (h*4 + w)*64 + c becomes column (c*4 + h)*4 + w."""
    k = np.zeros((1024, 512), np.float32)
    h, w, c = 2, 3, 17
    k[(h * 4 + w) * 64 + c, 5] = 1.0
    out = convert.params_to_torch({"fc": {"kernel": k}}, 64)["fc.weight"]
    assert out.shape == (512, 1024)
    assert out[5, (c * 4 + h) * 4 + w] == 1.0 and out.sum() == 1.0
    # other resolutions flatten other maps (3 x 3 x 64 at 20 pixels)
    k20 = np.arange(576 * 4, dtype=np.float32).reshape(576, 4)
    out20 = convert.params_to_torch({"fc": {"kernel": k20}}, 20)["fc.weight"]
    assert out20[1, (7 * 3 + 2) * 3 + 1] == k20[(2 * 3 + 1) * 64 + 7, 1]


def test_whole_sac_state_carries_adam_moments(tree):
    conv = convert.sac_state_to_torch(tree, 64)
    assert conv["step"] == int(tree["step"]) > 0
    for key in convert.SAC_OPT_KEYS:
        count, mu, nu = convert._adam_fields(tree[key])
        assert conv[key]["step"] == int(count)
    np.testing.assert_array_equal(
        conv["critic_opt"]["exp_avg"]["q1_torso.conv1.weight"].numpy(),
        np.asarray(tree["critic_opt"][0]["mu"]["params"]["q1_torso"]["conv1"]
                   ["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        conv["critic_opt"]["exp_avg_sq"]["q2_h.weight"].numpy(),
        np.asarray(tree["critic_opt"][0]["nu"]["params"]["q2_h"]["kernel"]).T)
    assert conv["critic_opt"]["exp_avg_sq"]["q1_out.bias"].abs().sum() > 0

    agent = SAC(SACConfig(), compute_dtype=torch.float32)
    agent.init(seed=0, device="cpu")
    st = agent.load_state(conv)
    assert st.step == int(tree["step"])
    assert float(st.log_alpha.detach()) == float(tree["log_alpha"])
    for opt, key, module in ((st.actor_opt, "actor_opt", st.actor),
                             (st.critic_opt, "critic_opt", st.critic)):
        for name, p in module.named_parameters():
            s = opt.state[p]
            assert float(s["step"]) == conv[key]["step"]
            assert torch.equal(s["exp_avg"], conv[key]["exp_avg"][name])
            assert torch.equal(s["exp_avg_sq"], conv[key]["exp_avg_sq"][name])
    s = st.alpha_opt.state[st.log_alpha]
    assert float(s["exp_avg"]) == float(tree["alpha_opt"][0]["mu"])
    # ... and back: the checkpoint's tree, exactly
    back = convert.sac_state_from_torch(agent.export_state(), 64)
    _assert_trees_equal(back, {k: tree[k] for k in back})


def test_live_jax_state_converts_like_a_restored_one():
    """``sac.init``'s optax states are tuples of named tuples, a restored
    checkpoint's are lists of dicts: both are read."""
    from torchdriveenv_tpu.rl import sac as jsac
    jstate = jsac.SAC().init(jax.random.PRNGKey(0), obs_res=16)
    tree = {k: jax.tree.map(np.asarray, getattr(jstate, k))
            for k in ("actor_params", "critic_params", "target_critic_params",
                      "log_alpha", "step", "actor_opt", "critic_opt",
                      "alpha_opt")}
    conv = convert.sac_state_to_torch(tree, 16)
    assert conv["actor_opt"]["step"] == 0
    assert conv["actor"]["torso.fc.weight"].shape == (512, 2 * 2 * 64)
    assert set(conv["alpha_opt"]["exp_avg"]) == {""}


# --------------------------------------------------------------------------
# PPO / A2C (a chained optimizer) and TD3 states
# --------------------------------------------------------------------------


def _np_tree(state, keys):
    return {k: jax.tree.map(np.asarray, getattr(state, k)) for k in keys}


@pytest.mark.parametrize("form", ["live", "restored"])
def test_adam_state_is_found_behind_a_clip(form, tmp_path):
    """``optax.chain(clip_by_global_norm, adam)`` nests Adam's state one
    level down: ``(EmptyState, (ScaleByAdamState, EmptyState))`` live,
    ``[None, [{count, mu, nu}, None]]`` once a checkpoint restored it."""
    from torchdriveenv_tpu.rl import ppo as jppo
    jstate = jppo.PPO().init(jax.random.PRNGKey(0), obs_res=16)
    # moments that tell parameters apart, and a count
    leaves, treedef = jax.tree.flatten(jstate.params)
    mu = jax.tree.unflatten(treedef, [jnp.full_like(x, i + 1.0)
                                      for i, x in enumerate(leaves)])
    adam = jstate.opt[1][0]._replace(count=jnp.asarray(7, jnp.int32), mu=mu,
                                     nu=jax.tree.map(lambda x: x * x, mu))
    jstate = jstate.replace(opt=(jstate.opt[0], (adam, jstate.opt[1][1])),
                            step=jnp.asarray(3, jnp.int32))
    tree = _np_tree(jstate, ("params", "opt", "step"))
    if form == "restored":
        path = str(tmp_path / "ppo_state")
        ocp.PyTreeCheckpointer().save(path, tree)
        tree = ocp.PyTreeCheckpointer().restore(path)
        assert tree["opt"][0] is None and isinstance(tree["opt"][1], list)
    count, mu_found, _ = convert._adam_fields(tree["opt"])
    assert int(count) == 7
    conv = convert.ppo_state_to_torch(tree, 16)
    assert conv["step"] == 3 and conv["opt"]["step"] == 7
    assert sorted(conv["net"]) == sorted(conv["opt"]["exp_avg"])
    assert "log_std" in conv["net"] and conv["net"]["log_std"].shape == (2,)
    np.testing.assert_array_equal(
        conv["opt"]["exp_avg"]["torso.conv1.weight"].numpy(),
        np.asarray(mu_found["params"]["torso"]["conv1"]["kernel"]
                   ).transpose(3, 2, 0, 1))
    # ... and back, in the restored form, exactly
    back = convert.ppo_state_from_torch(conv, 16)
    assert back["opt"][0] is None and back["opt"][1][1] is None
    if form == "restored":
        _assert_trees_equal(back, tree)
    else:
        _assert_trees_equal(back["params"], tree["params"])
        _assert_trees_equal(back["opt"][1][0]["mu"], mu_found)
    assert convert.a2c_state_to_torch is convert.ppo_state_to_torch


def test_ppo_state_loads_into_the_agent_and_comes_back():
    from torchdriveenv_tpu.rl import a2c as ja2c
    from torchdriveenv_tpu_torch.rl.a2c import A2C
    jstate = ja2c.A2C().init(jax.random.PRNGKey(1), obs_res=20)
    tree = _np_tree(jstate, ("params", "opt", "step"))
    agent = A2C(compute_dtype=torch.float32)
    agent.init(seed=0, obs_res=20, device="cpu")
    agent.load_state(convert.a2c_state_to_torch(tree, 20))
    back = convert.a2c_state_from_torch(agent.export_state(), 20)
    _assert_trees_equal(back["params"], tree["params"])
    count, mu, nu = convert._adam_fields(tree["opt"])
    assert int(back["opt"][1][0]["count"]) == int(count) == 0
    _assert_trees_equal(back["opt"][1][0]["mu"], mu)
    _assert_trees_equal(back["opt"][1][0]["nu"], nu)
    with pytest.raises(ValueError, match="no Adam state"):
        convert._adam_fields([None, [None, None]])


def test_whole_td3_state_round_trips(tmp_path):
    from torchdriveenv_tpu.rl import td3 as jtd3
    from torchdriveenv_tpu_torch.rl.td3 import TD3
    keys = ("actor_params", "target_actor_params", "critic_params",
            "target_critic_params", "actor_opt", "critic_opt", "step")
    jagent = jtd3.TD3()
    jstate = jagent.init(jax.random.PRNGKey(2), obs_res=20)
    rng = np.random.default_rng(0)
    batch = dict(
        obs=rng.integers(0, 256, (4, 9, 20, 20), dtype=np.uint8),
        next_obs=rng.integers(0, 256, (4, 9, 20, 20), dtype=np.uint8),
        action=rng.uniform(-1, 1, (4, 2)).astype(np.float32),
        reward=rng.normal(size=4).astype(np.float32),
        discount_mask=np.ones(4, np.float32))
    # one update: non-zero moments, targets that differ from their nets
    jstate, _ = jax.jit(jagent.update)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(3))
    path = str(tmp_path / "td3_state")
    ocp.PyTreeCheckpointer().save(path, _np_tree(jstate, keys))
    tree = ocp.PyTreeCheckpointer().restore(path)
    conv = convert.td3_state_to_torch(tree, 20)
    assert conv["step"] == 1 and conv["critic_opt"]["step"] == 1
    assert conv["actor_opt"]["step"] == 1            # update 0 moves the actor
    assert not torch.equal(conv["actor"]["mu.weight"],
                           conv["target_actor"]["mu.weight"])
    agent = TD3(compute_dtype=torch.float32)
    agent.init(seed=0, obs_res=20, device="cpu")
    st = agent.load_state(conv)
    for name, p in st.critic.named_parameters():
        s = st.critic_opt.state[p]
        assert float(s["step"]) == 1.0 and s["step"].device.type == "cpu"
        assert torch.equal(s["exp_avg"], conv["critic_opt"]["exp_avg"][name])
    assert st.critic_opt.state[st.critic.q1_out.weight]["exp_avg"].abs().sum() > 0
    back = convert.td3_state_from_torch(agent.export_state(), 20)
    _assert_trees_equal(back, tree)


# --------------------------------------------------------------------------
# the GRU NPC policy
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def npc_tree():
    from tools import export_torch_npc
    return export_torch_npc.restore(export_torch_npc.DEFAULT_PARAMS)


def test_npc_params_round_trip_is_exact(npc_tree):
    state = convert.npc_params_to_torch(npc_tree)
    assert state["GRUCell_0.ir.weight"].shape == (16, 9)
    assert "GRUCell_0.hr.bias" not in state and "GRUCell_0.hn.bias" in state
    np.testing.assert_array_equal(
        state["GRUCell_0.in.weight"].numpy(),
        npc_tree["params"]["GRUCell_0"]["in"]["kernel"].T)
    back = convert.npc_params_from_torch(state)
    _assert_trees_equal(back, npc_tree)
    again = convert.npc_params_to_torch(back)
    for k in state:
        assert torch.equal(again[k], state[k]), k


def test_committed_npc_npz_is_the_conversion_of_the_msgpack(npc_tree):
    from tools import export_torch_npc
    from torchdriveenv_tpu_torch.npc import policy_net as tpn
    want = export_torch_npc.npc_arrays(npc_tree)
    shipped = tpn.default_params("cpu").state_dict()
    with np.load(tpn.NPC_POLICY) as z:
        assert sorted(z.files) == sorted(want) == sorted(shipped)
        for k in z.files:
            assert z[k].dtype == np.float32, k
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
            np.testing.assert_array_equal(shipped[k].numpy(), z[k], err_msg=k)


@pytest.mark.parametrize("change", ["hidden-side bias", "missing layer",
                                    "other width"])
def test_npc_converter_refuses_other_trees(npc_tree, change):
    import copy
    tree = copy.deepcopy(npc_tree)
    gru = tree["params"]["GRUCell_0"]
    if change == "hidden-side bias":          # torch.nn.GRUCell's layout
        gru["hr"]["bias"] = np.zeros(16, np.float32)
    elif change == "missing layer":
        del tree["params"]["Dense_1"]
    else:
        gru["iz"]["kernel"] = np.zeros((9, 32), np.float32)
    with pytest.raises(ValueError, match="GRU NPC policy"):
        convert.npc_params_to_torch(tree)
