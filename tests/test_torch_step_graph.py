"""The env step replayed as a chain of CUDA graphs (``env/batched.py``
``StepGraphs``), held to the eager step bit for bit.

On the CPU the chain runs with a stand-in for the capture that records each
segment and replays it by running it again into the same output tensors,
so the segments, the static inputs, the copies in and out and the counts
are checked without a card; unchanged, the CPU step stays eager. The
``cuda`` cases capture real graphs at 4096 envs. This module imports
nothing of JAX; on the card, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_step_graph.py -m cuda
"""

import dataclasses

import pytest
import torch

from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import batched
from torchdriveenv_tpu_torch.maps.arrays import load_assets
from torchdriveenv_tpu_torch.utils import spans

torch.set_num_threads(2)
B, STEPS = 8, 6
NPC = ("route", "policy")
RESET = {"pooled": 4, "exact": 0}
ENV_SPANS = ("env.step", "env.core", "env.npc", "env.autoreset",
             "env.render", "env.render_inputs")


def _spans_per_step(name, with_final_obs=False):
    """How often a step opens the span ``name``: the auto-reset twice (its
    draws first, then the reset), the render twice with final
    observations."""
    if name == "env.autoreset":
        return 2
    return 2 if with_final_obs and name.startswith("env.render") else 1


def _kept(chain):
    """The storages of every tensor a chain keeps: its static inputs and
    its graphs' outputs."""
    return {t.untyped_storage().data_ptr() for t in batched._leaves(
        (chain.inputs, [out for _, out in chain.graphs]))}


@pytest.fixture(scope="module")
def assets():
    return load_assets("val", device="cpu")


@pytest.fixture(autouse=True)
def empty_log():
    spans.clear()
    yield
    spans.clear()


def _stand_in_capture(fn, args, ctx):
    """A graph's stand-in: run ``fn`` once for its outputs; each replay runs
    it again on the same inputs and writes the results into them."""
    out = fn(*args)

    def replay():
        new = fn(*args)
        for o, n in zip(batched._leaves(out), batched._leaves(new)):
            if o is not n:
                o.copy_(n)

    return replay, out


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(batched, "_graphed", lambda device, mesh: True)
    monkeypatch.setattr(batched, "_capture", _stand_in_capture)


def _cfg(npc="route", reset="pooled"):
    # episodes of 3 steps: every env is done at the third
    return EnvConfig(npc_mode=npc, reset_pool=RESET[reset],
                     max_environment_steps=3)


def _tensors(out):
    """Every tensor of a step's output, by name."""
    d = {f"state.{f.name}": getattr(out.state, f.name)
         for f in dataclasses.fields(out.state)
         if getattr(out.state, f.name) is not None}
    d.update({k: v for k, v in out._asdict().items()
              if isinstance(v, torch.Tensor)})
    d.update({f"info.{k}": v for k, v in out.info.items()})
    return d


def _assert_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and torch.equal(ta[k], tb[k]), k


def _rollout(step_fn, state, actions, gen, steps):
    outs = []
    for _ in range(steps):
        outs.append(step_fn(state, actions, gen))
        state = outs[-1].state
    return outs


@pytest.mark.parametrize("with_final_obs", [False, True],
                         ids=["obs", "final_obs"])
@pytest.mark.parametrize("reset", list(RESET))
@pytest.mark.parametrize("npc", NPC)
def test_segments_compose_the_step_bit_for_bit(assets, stand_in, npc, reset,
                                               with_final_obs):
    """The step run segment by segment through the chain (one eager call,
    the capture, then replays, across two rounds of resets) equals the
    eager step, output for output, and leaves the generator where the eager
    step leaves it."""
    cfg = _cfg(npc, reset)
    reset_fn, graph_step = batched.make_env_fns(cfg, assets,
                                                with_final_obs=with_final_obs)
    assert graph_step.graphs is not None
    with pytest.MonkeyPatch.context() as m:
        m.setattr(batched, "_graphed", lambda device, mesh: False)
        _, eager_step = batched.make_env_fns(cfg, assets,
                                             with_final_obs=with_final_obs)
    assert eager_step.graphs is None
    g = torch.Generator().manual_seed(0)
    state, _ = reset_fn(g, B)
    start = g.get_state()
    actions = torch.tensor([[0.4, 0.05]]).repeat(B, 1)
    want = _rollout(eager_step, state, actions, g, STEPS)
    want_gen = g.get_state()
    g.set_state(start)
    with spans.recording():
        got = _rollout(graph_step, state, actions, g, STEPS)
    assert torch.equal(g.get_state(), want_gen)
    for a, b in zip(got, want):
        _assert_equal(a, b)
    assert sum(int((o.terminated | o.truncated).sum()) for o in got) >= 2 * B
    counts = spans.counters()
    assert counts["env.eager_steps"] == 1
    assert counts["env.graph_captures"] == 1
    assert counts["env.graph_replays"] == STEPS - 2
    assert counts["envs_reset"] == sum(int((o.terminated | o.truncated).sum())
                                       for o in got)
    names = [r["name"] for r in spans.records()]
    for name in ENV_SPANS:
        assert names.count(name) == _spans_per_step(
            name, with_final_obs) * STEPS, name


@pytest.mark.parametrize("with_final_obs", [False, True],
                         ids=["obs", "final_obs"])
@pytest.mark.parametrize("npc", NPC)
def test_an_output_is_the_callers(assets, stand_in, npc, with_final_obs):
    """A returned StepOutput is unchanged by every later call, and none of
    its tensors is one the chain keeps."""
    reset_fn, step_fn = batched.make_env_fns(_cfg(npc), assets,
                                             with_final_obs=with_final_obs)
    g = torch.Generator().manual_seed(1)
    state, _ = reset_fn(g, B)
    actions = torch.tensor([[0.4, 0.05]]).repeat(B, 1)
    outs = _rollout(step_fn, state, actions, g, STEPS)
    (chain,) = step_fn.graphs.chains.values()
    kept = _kept(chain)
    for out in outs:
        for t in _tensors(out).values():
            assert t.untyped_storage().data_ptr() not in kept
    snaps = [{k: v.clone() for k, v in _tensors(o).items()} for o in outs]
    _rollout(step_fn, outs[-1].state, actions, g, 3)
    for out, snap in zip(outs, snaps):
        for k, v in _tensors(out).items():
            assert torch.equal(v, snap[k]), k


@pytest.mark.parametrize("npc", NPC)
def test_the_cpu_step_stays_eager(assets, npc):
    reset_fn, step_fn = batched.make_env_fns(_cfg(npc), assets)
    assert step_fn.graphs is None
    g = torch.Generator().manual_seed(2)
    state, _ = reset_fn(g, B)
    actions = torch.tensor([[0.4, 0.05]]).repeat(B, 1)
    with spans.recording():
        _rollout(step_fn, state, actions, g, 3)
    assert set(spans.counters()) == {"envs_reset"}
    names = [r["name"] for r in spans.records()]
    for name in ENV_SPANS:
        assert names.count(name) == _spans_per_step(name) * 3, name


def test_a_new_batch_captures_anew(assets, stand_in):
    reset_fn, step_fn = batched.make_env_fns(_cfg(), assets)
    g = torch.Generator().manual_seed(3)
    with spans.recording():
        for b in (B, 2 * B, B):
            state, _ = reset_fn(g, b)
            actions = torch.tensor([[0.4, 0.05]]).repeat(b, 1)
            _rollout(step_fn, state, actions, g, 3)
    assert len(step_fn.graphs.chains) == 2
    assert all(c.graphs for c in step_fn.graphs.chains.values())
    counts = spans.counters()
    assert counts["env.eager_steps"] == 2
    assert counts["env.graph_captures"] == 2
    assert counts["env.graph_replays"] == 5


def test_a_new_layout_replays_the_same_chain(assets, stand_in):
    """Actions of another layout (a transposed view) are copied into the
    chain's static actions: no new capture, and the step equals the one on
    contiguous actions."""
    reset_fn, step_fn = batched.make_env_fns(_cfg(), assets)
    g = torch.Generator().manual_seed(4)
    state, _ = reset_fn(g, B)
    actions = torch.tensor([[0.4, 0.05]]).repeat(B, 1)
    state = _rollout(step_fn, state, actions, g, 2)[-1].state
    start = g.get_state()
    want = step_fn(state, actions, g)
    g.set_state(start)
    strided = actions.t().contiguous().t()
    assert strided.stride() != actions.stride()
    with spans.recording():
        got = step_fn(state, strided, g)
    _assert_equal(got, want)
    assert len(step_fn.graphs.chains) == 1
    assert spans.counters().get("env.graph_captures") is None
    assert spans.counters()["env.graph_replays"] == 1


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CARD_ENVS, CARD_STEPS = 4096, 40


@pytest.fixture(scope="module")
def card_assets():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    from torchdriveenv_tpu_torch.utils.precision import set_f32_precision
    set_f32_precision()
    return load_assets("train", device="cuda")


def _card_fns(assets, npc, graphed):
    cfg = EnvConfig(npc_mode=npc)
    with pytest.MonkeyPatch.context() as m:
        if not graphed:
            m.setattr(batched, "_graphed", lambda device, mesh: False)
        return batched.make_env_fns(cfg, assets)


@pytest.mark.cuda
@pytest.mark.parametrize("npc", NPC)
def test_graphs_match_the_eager_step_on_the_card(card_assets, npc):
    """At 4096 envs: 40 replayed steps equal the eager step's bit for bit
    and leave the generator where it leaves it; no output is a static
    tensor of the chain; a new batch captures anew and matches too; the
    span log has each env span once a step and counts the done envs."""
    reset_fn, graph_step = _card_fns(card_assets, npc, graphed=True)
    _, eager_step = _card_fns(card_assets, npc, graphed=False)
    assert graph_step.graphs is not None and eager_step.graphs is None
    g = torch.Generator(device="cuda").manual_seed(0)

    def both(num_envs, steps):
        state, _ = reset_fn(g, num_envs)
        actions = (torch.rand((num_envs, 2), generator=g, device="cuda")
                   * 2.0 - 1.0)
        start = g.get_state()
        want = _rollout(eager_step, state, actions, g, steps)
        want_gen = g.get_state()
        g.set_state(start)
        got = _rollout(graph_step, state, actions, g, steps)
        assert torch.equal(g.get_state(), want_gen)
        for a, b in zip(got, want):
            _assert_equal(a, b)
        return got, actions

    got, actions = both(CARD_ENVS, CARD_STEPS)
    chains = graph_step.graphs.chains
    assert len(chains) == 1
    (chain,) = chains.values()
    kept = _kept(chain)
    for out in got:
        for t in _tensors(out).values():
            assert t.untyped_storage().data_ptr() not in kept

    state = got[-1].state
    with spans.recording():
        outs = _rollout(graph_step, state, actions, g, 5)
    names = [r["name"] for r in spans.records()]
    for name in ENV_SPANS:
        assert names.count(name) == _spans_per_step(name) * 5, name
    assert all(r["stream_ms"] is not None for r in spans.records())
    counts = spans.counters()
    assert counts["env.graph_replays"] == 5 and "env.eager_steps" not in counts
    assert counts["envs_reset"] == sum(
        int((o.terminated | o.truncated).sum()) for o in outs)
    spans.clear()

    both(CARD_ENVS // 4, 4)
    assert len(chains) == 2 and all(c.graphs for c in chains.values())
