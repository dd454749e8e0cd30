"""The NPC controller's CUDA kernel (``csrc/npc_gaps.cu``, through
``npc/route_follow.py:nearest_obstacles``) against its plain twins
``leader_gaps`` and ``light_gaps``, on the card: bit for bit.

This module imports nothing of JAX, so it runs on a GPU machine that has no
JAX or Flax (the twins are held to the JAX package on the CPU in
``tests/test_torch_route_follow.py``). Every case skips without a CUDA
device: the kernel has no CPU mode. On the card, from the repository root
(the ``--noconftest`` keeps the test configuration, which imports JAX, out):

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_npc_gaps_cuda.py -m cuda
"""

import math

import pytest
import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env.batched import make_env_fns
from torchdriveenv_tpu_torch.maps.arrays import load_assets
from torchdriveenv_tpu_torch.npc import route_follow as rf

CARD_ENVS = 4096
CHECKED_STEPS = (0, 50, 200)


@pytest.fixture(scope="module")
def card_assets():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return load_assets("train", device="cuda")


def _t(state):
    return state.time0 + state.step_idx.to(torch.float32) * 0.1


def _both(maps, town, t, states, attrs, present):
    """The kernel's outputs (through ``nearest_obstacles``, which takes it
    for CUDA tensors) and the twins'; asserts one counted launch."""
    before = rf.npc_gaps_cuda.launches
    kern = rf.nearest_obstacles(maps, town, t, states, attrs, present)
    twin = (*rf.leader_gaps(states, attrs, present),
            rf.light_gaps(maps, town, t, states, attrs))
    torch.cuda.synchronize()
    assert rf.npc_gaps_cuda.launches == before + 1
    return kern, twin


def _assert_bit_equal(kern, twin):
    for name, k, w in zip(("leader_gap", "leader_v", "light_gap"), kern, twin):
        assert k.shape == w.shape and k.dtype == torch.float32, name
        same = (k == w) | (torch.isnan(k) & torch.isnan(w))
        assert bool(same.all()), (
            f"{name}: {int((~same).sum())} of {same.numel()} differ")


@pytest.mark.cuda
@pytest.mark.parametrize("npc", ("route", "policy"))
def test_kernel_matches_twins_on_the_graphed_step(card_assets, npc):
    """At 4096 train envs after 0, 50 and 200 replayed steps of the env
    step (uniform random actions), the kernel equals the twins bit for bit
    in both NPC modes, and the scenes hold leaders and red stoplines."""
    reset_fn, step_fn = make_env_fns(EnvConfig(npc_mode=npc), card_assets)
    assert step_fn.graphs is not None
    g = torch.Generator(device="cuda").manual_seed(19)
    state, _ = reset_fn(g, CARD_ENVS)
    for k in range(max(CHECKED_STEPS) + 1):
        if k in CHECKED_STEPS:
            kern, twin = _both(card_assets.maps, state.town, _t(state),
                               state.agent_states, state.agent_attrs,
                               state.present)
            _assert_bit_equal(kern, twin)
            assert int(torch.isfinite(twin[0]).sum()) > CARD_ENVS
            assert int(torch.isfinite(twin[2]).sum()) > 0
        actions = torch.rand((CARD_ENVS, 2), generator=g, device="cuda") * 2 - 1
        state = step_fn(state, actions, g).state


@pytest.mark.cuda
def test_kernel_edge_shapes(card_assets):
    """One env (B = 1), an odd agent count (A = 37), more agents than a
    block owns at once (A = 200), a single agent, and an env with no
    present agent."""
    reset_fn, step_fn = make_env_fns(EnvConfig(), card_assets, render=False)
    g = torch.Generator(device="cuda").manual_seed(7)
    state, _ = reset_fn(g, 64)
    for _ in range(20):
        state = step_fn(state, torch.rand((64, 2), generator=g,
                                          device="cuda") * 2 - 1, g).state
    maps, t = card_assets.maps, _t(state)
    s, a, p = state.agent_states, state.agent_attrs, state.present

    def check(rows, agents, present=None):
        pr = p[rows][:, agents] if present is None else present
        _assert_bit_equal(*_both(maps, state.town[rows], t[rows],
                                 s[rows][:, agents], a[rows][:, agents], pr))

    check(slice(3, 4), slice(None))                       # B = 1
    check(slice(None), slice(0, 37))                      # odd A
    check(slice(None), slice(0, 1))                       # A = 1
    empty = p.clone()
    empty[5] = False
    check(slice(None), slice(None), empty)                # no present agent
    # A = 200: the scene's agents twice, the copies shifted 3 m sideways
    wide = torch.cat([s, s + torch.tensor([0.0, 3.0, 0.0, 0.0],
                                          device="cuda")], dim=1)
    _assert_bit_equal(*_both(maps, state.town, t, wide,
                             torch.cat([a, a], dim=1),
                             torch.cat([p, p], dim=1)))


@pytest.mark.cuda
def test_a_tie_goes_to_the_lower_index(card_assets):
    """Two obstacles at the same gap: the lower j is the leader, whose
    projected speed is reported, as argmin's first minimum has it."""
    dev = "cuda"
    states = torch.tensor([[[0.0, 0.0, 0.0, 5.0], [10.0, 0.5, 0.0, 3.0],
                            [10.0, -0.5, 0.0, 7.0], [10.0, 0.0, math.pi, 1.0]]],
                          device=dev)
    attrs = torch.tensor([[[4.0, 2.0, 0.0]] * 4], device=dev)
    present = torch.tensor([[True, True, True, False]], device=dev)
    town = torch.zeros(1, dtype=torch.int32, device=dev)
    kern, twin = _both(card_assets.maps, town, torch.zeros(1, device=dev),
                       states, attrs, present)
    _assert_bit_equal(kern, twin)
    assert kern[0][0, 0].item() == 6.0 and kern[1][0, 0].item() == 3.0
