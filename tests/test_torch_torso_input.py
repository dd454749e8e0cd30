"""The torso's input made once per stack in an off-policy update
(``models/cnn.py:torso_input``): SAC's and TD3's updates hand each of their
two stacks' input, made once, to every actor, critic and target torso, and
give bit for bit the losses, gradients, parameters and Adam states of the
same updates with the uint8 stack handed to every torso call; an update
makes 2 inputs; ``NatureCNN.forward`` takes the stack or the input made.

On the CPU the input made is the NCHW ``exact_div(obs.to(dtype), 255)``
that every torso made from the stack before; the card's kernel is held to
its plain twin in ``tests/test_torch_torso_input_cuda.py``.
"""

import numpy as np
import pytest
import torch

from torchdriveenv_tpu_torch.maps.arrays import exact_div
from torchdriveenv_tpu_torch.models import cnn
from torchdriveenv_tpu_torch.rl import sac, td3

torch.set_num_threads(2)
B, RES = 8, 20
UPDATES = 3         # TD3 (policy delay 2): two that move the actor, one not
LEARNERS = {"sac": (sac, sac.SAC, sac.SACConfig),
            "td3": (td3, td3.TD3, td3.TD3Config)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    b = dict(
        obs=rng.integers(0, 256, (B, 9, RES, RES), dtype=np.uint8),
        next_obs=rng.integers(0, 256, (B, 9, RES, RES), dtype=np.uint8),
        action=rng.uniform(-1, 1, (B, 2)).astype(np.float32),
        reward=rng.normal(size=B).astype(np.float32),
        discount_mask=(rng.random(B) > 0.25).astype(np.float32),
        is_demo=np.arange(B) % 2 == 0)
    batch = {k: torch.from_numpy(v) for k, v in b.items()}
    batch["pos"] = torch.arange(B)
    return batch


def _noise(kind, seed):
    g = torch.Generator().manual_seed(seed)
    n = [torch.randn((B, 2), generator=g) for _ in range(2)]
    return n if kind == "sac" else n[0]


def _agent(kind, dtype):
    _, cls, cfg = LEARNERS[kind]
    kw = dict(batch_size=B, bc_coef=0.5) if kind == "sac" else {}
    agent = cls(cfg(**kw), compute_dtype=dtype)
    agent.init(seed=3, obs_res=RES, device="cpu")
    return agent


def _updates(kind, dtype, monkeypatch, made_once):
    """UPDATES updates of a fresh agent -> (each update's metrics, each Adam
    step's gradients, the agent). ``made_once`` False: the learner hands the
    uint8 stacks on, and every torso call makes its own input."""
    mod = LEARNERS[kind][0]
    grads = []
    plain = mod.apply_grads

    def recorded(opt, params, gs):
        grads.append([g.detach().clone() for g in gs])
        return plain(opt, params, gs)

    with monkeypatch.context() as m:
        m.setattr(mod, "apply_grads", recorded)
        if not made_once:
            m.setattr(mod, "torso_input", lambda obs, dtype: obs)
        agent = _agent(kind, dtype)
        metrics = [agent.update(_batch(i), noise=_noise(kind, 100 + i))
                   for i in range(UPDATES)]
    return metrics, grads, agent


def _assert_equal_trees(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_equal_trees(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal_trees(g, w, f"{path}/{i}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path
    else:
        assert got == want, path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_inputs_made_once_give_the_updates_bit_for_bit(kind, dtype,
                                                       monkeypatch):
    got_m, got_g, got = _updates(kind, dtype, monkeypatch, made_once=True)
    want_m, want_g, want = _updates(kind, dtype, monkeypatch,
                                    made_once=False)
    _assert_equal_trees(got_m, want_m, "metrics")
    assert len(got_g) >= UPDATES + 2     # every critic step, two actor steps
    _assert_equal_trees(got_g, want_g, "grads")
    # parameters, targets, Adam's moments and step counts (SAC: log_alpha)
    _assert_equal_trees(got.export_state(), want.export_state(), "state")
    assert float(got_m[-1]["critic_loss"]) > 0


@pytest.mark.parametrize("kind", sorted(LEARNERS))
def test_an_update_makes_each_stack_input_once(kind, monkeypatch):
    """Each update makes 2 inputs (the stacks and the next stacks), and no
    torso call makes its own: 8 torso calls in a SAC update, 8 in a TD3
    update that moves the actor and 5 in one that does not."""
    mod = LEARNERS[kind][0]
    made, uint8_calls, calls = [], [], []
    plain_input, plain_forward = cnn.torso_input, cnn.NatureCNN.forward

    def counted_input(obs, dtype):
        made.append(tuple(obs.shape))
        return plain_input(obs, dtype)

    def counted_forward(self, obs):
        calls.append(1)
        uint8_calls.append(obs.dtype == torch.uint8)
        return plain_forward(self, obs)

    monkeypatch.setattr(mod, "torso_input", counted_input)
    monkeypatch.setattr(cnn, "torso_input", counted_input)
    monkeypatch.setattr(cnn.NatureCNN, "forward", counted_forward)
    agent = _agent(kind, torch.float32)
    per_update = []
    for i in range(UPDATES):
        made.clear()
        calls.clear()
        agent.update(_batch(i), noise=_noise(kind, 100 + i))
        per_update.append((len(made), len(calls)))
        assert made == [(B, 9, RES, RES)] * 2
    assert not any(uint8_calls)
    want = ([(2, 8)] * UPDATES if kind == "sac"
            else [(2, 8), (2, 5), (2, 8)])
    assert per_update == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("res", [64, RES])
def test_forward_takes_the_stack_or_its_input(res, dtype):
    torch.manual_seed(0)
    torso = cnn.NatureCNN(9, obs_res=res, compute_dtype=dtype)
    obs = torch.randint(0, 256, (3, 9, res, res), dtype=torch.uint8)
    x = cnn.torso_input(obs, dtype)
    assert x.dtype == dtype and x.is_contiguous()
    assert torch.equal(x, exact_div(obs.to(dtype), 255.0))
    with torch.no_grad():
        assert torch.equal(torso(x), torso(obs))
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    with pytest.raises(TypeError, match="torso_input"):
        torso(obs.to(other))
    # an input of the right dtype in another layout than torso_input's
    with pytest.raises(TypeError, match="torso_input"):
        torso(x.contiguous(memory_format=torch.channels_last))


def test_the_kernel_wrapper_takes_only_cuda_stacks():
    obs = torch.zeros((2, 9, 64, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        cnn.torso_input_cuda(obs)
