"""The port's replay buffer and frame-stack ops against the JAX package's on
one shared stream: the same ``add`` calls (terminations, truncations and
demo masks from a seed; a ring of 16 cells that wraps more than twice), then
``sample`` with the very ``env_idx`` / ``off`` draws JAX makes from its key.
Every field and every sampled tensor must be equal, bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchdriveenv_tpu.rl import buffer as jbuffer
from torchdriveenv_tpu.rl import rollout as jrollout
from torchdriveenv_tpu_torch.rl import buffer as tbuffer
from torchdriveenv_tpu_torch.rl import rollout as trollout

torch.set_num_threads(2)
E, N, RES, STEPS, FS = 5, 16, 8, 40, 3
FIELDS = [f.name for f in dataclasses.fields(tbuffer.ReplayBuffer)]


def _stream(seed=0):
    """STEPS add calls: frames, actions, rewards, done kinds, demo masks."""
    rng = np.random.default_rng(seed)
    rows = []
    for t in range(STEPS):
        kind = rng.choice(3, size=E, p=[0.8, 0.1, 0.1])   # 0 run, 1 term, 2 trunc
        rows.append(dict(
            frame=rng.integers(0, 256, (E, 3, RES, RES), dtype=np.uint8),
            action=rng.uniform(-1, 1, (E, 2)).astype(np.float32),
            reward=rng.normal(size=E).astype(np.float32),
            done=kind > 0, terminal=kind == 1,
            final=rng.integers(0, 256, (E, 3, RES, RES), dtype=np.uint8),
            demo=(rng.random(E) < 0.4) if t % 3 else None))
    return rows


def _jadd(buf, r):
    dm = None if r["demo"] is None else jnp.asarray(r["demo"])
    return jbuffer.add(buf, jnp.asarray(r["frame"]), jnp.asarray(r["action"]),
                       jnp.asarray(r["reward"]), jnp.asarray(r["done"]),
                       jnp.asarray(r["terminal"]), jnp.asarray(r["final"]),
                       demo_mask=dm)


def _tadd(buf, r):
    dm = None if r["demo"] is None else torch.from_numpy(r["demo"])
    return tbuffer.add(buf, *(torch.from_numpy(r[k]) for k in (
        "frame", "action", "reward", "done", "terminal", "final")),
        demo_mask=dm)


def _assert_buffers_equal(tbuf, jbuf, where):
    for k in FIELDS:
        t, j = getattr(tbuf, k).numpy(), np.asarray(getattr(jbuf, k))
        assert t.dtype == j.dtype and t.shape == j.shape, (where, k)
        np.testing.assert_array_equal(t, j, err_msg=f"{where}: {k}")


def _jax_draws(key, batch, e, filled):
    """The draws of ``jbuffer.sample`` (its lines that split the key)."""
    k_env, k_idx = jax.random.split(key)
    env_idx = jax.random.randint(k_env, (batch,), 0, e)
    upper = jnp.maximum(filled - 1, 1)
    off = jax.random.randint(k_idx, (batch,), 0, upper)
    return np.asarray(env_idx), np.asarray(off)


@pytest.fixture(scope="module")
def both():
    """Both buffers after the whole stream, checked equal after each add,
    with snapshots of the sampled batches taken on the way."""
    jbuf = jbuffer.create(E, N, (3, RES, RES))
    tbuf = tbuffer.create(E, N, (3, RES, RES), device="cpu")
    _assert_buffers_equal(tbuf, jbuf, "create")
    samples = {}
    for t, r in enumerate(_stream()):
        jbuf, tbuf = _jadd(jbuf, r), _tadd(tbuf, r)
        _assert_buffers_equal(tbuf, jbuf, f"add {t}")
        if t + 1 in (1, 2, 7, N, N + 1, STEPS):
            key = jax.random.PRNGKey(100 + t)
            want = jbuffer.sample(jbuf, key, 64, FS)
            idx = _jax_draws(key, 64, E, jbuf.filled)
            got = tbuffer.sample(tbuf, 64, FS, indices=tuple(
                torch.from_numpy(x.copy()) for x in idx))
            samples[t + 1] = (got, want)
    return tbuf, jbuf, samples


def test_layout_and_side_ring_size():
    buf = tbuffer.create(3, 640, (3, 8, 8), device="cpu")
    assert len(FIELDS) == 13
    assert buf.term_frames.shape == (3, 10, 3, 8, 8)
    assert tbuffer.create(3, 100, (3, 8, 8), device="cpu"
                          ).term_frames.shape[1] == 8
    assert buf.frames.dtype == torch.uint8 and buf.pos.dtype == torch.int32
    if not torch.cuda.is_available():       # the default device is the GPU
        with pytest.raises(RuntimeError, match="CUDA"):
            tbuffer.create(3, 16, (3, 8, 8))


def test_add_stream_matches_jax_exactly(both):
    tbuf, jbuf, _ = both
    assert int(tbuf.pos) == STEPS and int(tbuf.filled) == N   # wrapped
    assert int(tbuf.term_ptr.sum()) > 0, "the stream truncates episodes"
    assert tbuf.is_demo.any() and tbuf.terminal.any()
    _assert_buffers_equal(tbuf, jbuf, "end")


@pytest.mark.parametrize("after", [1, 2, 7, N, N + 1, STEPS])
def test_sample_matches_jax_exactly(both, after):
    got, want = both[2][after]
    assert sorted(got) == sorted(
        ["obs", "action", "reward", "next_obs", "discount_mask", "done",
         "is_demo", "pos"])
    assert sorted(want) == sorted(k for k in got if k != "pos")
    # one process: every row of the batch is this process's
    assert torch.equal(got["pos"], torch.arange(64))
    for k in want:
        t, j = got[k].numpy(), np.asarray(want[k])
        assert t.dtype == j.dtype and t.shape == j.shape, k
        np.testing.assert_array_equal(t, j, err_msg=k)
    assert got["obs"].shape == (64, 3 * FS, RES, RES)


def test_sample_covers_truncated_and_clamped_cells(both):
    """The stream's last sample exercises every branch of the gather."""
    got, _ = both[2][STEPS]
    trunc = got["done"] & (got["discount_mask"] == 1.0)
    assert trunc.any() and (got["discount_mask"] == 0.0).any()
    # a stack clamped at its episode's start repeats that first frame
    assert (got["obs"][:, :3] == got["obs"][:, 3:6]).flatten(1).all(1).any()


def test_own_draws_are_in_range_and_repeatable(both):
    tbuf = both[0]
    a = tbuffer.sample(tbuf, 256, FS, generator=torch.Generator().manual_seed(5))
    b = tbuffer.sample(tbuf, 256, FS, generator=torch.Generator().manual_seed(5))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # with one cell written, the only valid offset is 0
    one = tbuffer.create(E, N, (3, RES, RES), device="cpu")
    one = _tadd(one, _stream()[0])
    s = tbuffer.sample(one, 32, FS, generator=torch.Generator().manual_seed(1))
    assert s["obs"].shape == (32, 9, RES, RES)


def test_offsets_drawn_cover_the_filled_range():
    buf = tbuffer.create(2, 8, (3, 4, 4), device="cpu")
    for t in range(6):
        z = torch.zeros(2, 3, 4, 4, dtype=torch.uint8)
        buf = tbuffer.add(buf, z + t, torch.zeros(2, 2),
                          torch.full((2,), float(t)), torch.zeros(2, dtype=bool),
                          torch.zeros(2, dtype=bool), z)
    s = tbuffer.sample(buf, 4096, 1, generator=torch.Generator().manual_seed(0))
    # filled = 6: cells 0..4 are valid (the newest, 5, has no successor yet)
    assert sorted(set(s["reward"].tolist())) == [0.0, 1.0, 2.0, 3.0, 4.0]
    assert torch.equal(s["next_obs"][:, 0, 0, 0].float(), s["reward"] + 1)


@pytest.mark.parametrize("frame_stack", [1, 3, 4])
def test_stack_ops_match_jax_exactly(frame_stack):
    rng = np.random.default_rng(frame_stack)
    obs = rng.integers(0, 256, (E, 3, RES, RES), dtype=np.uint8)
    tstack = trollout.init_stack(torch.from_numpy(obs), frame_stack)
    jstack = jrollout.init_stack(jnp.asarray(obs), frame_stack)
    np.testing.assert_array_equal(tstack.numpy(), np.asarray(jstack))
    for _ in range(5):
        new = rng.integers(0, 256, (E, 3, RES, RES), dtype=np.uint8)
        done = rng.random(E) < 0.3
        tstack = trollout.update_stack(tstack, torch.from_numpy(new),
                                       torch.from_numpy(done))
        jstack = jrollout.update_stack(jstack, jnp.asarray(new),
                                       jnp.asarray(done))
        assert tstack.dtype == torch.uint8
        np.testing.assert_array_equal(tstack.numpy(), np.asarray(jstack))
        # oldest first: the newest frame is the last slice
        assert torch.equal(tstack[:, -3:], torch.from_numpy(new))
