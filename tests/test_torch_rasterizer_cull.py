"""The cull of the port's rasterizer kernel, on the CPU.

The CUDA kernel skips segments that cannot reach the frame and, per
16 x 16-pixel tile, the segments, boxes, discs and stoplines that cannot
reach the tile. ``cull_masks_torch`` states those predicates in plain torch.
These tests hold them against the twin's exact per-pixel tests:

* conservative: nothing that hits a pixel of a tile (of the frame) is masked
  out for that tile (dropped from the frame);
* sufficient: a render assembled tile by tile from the masked primitives and
  the twin's pixel functions equals the full-scan twin byte for byte, and
  the un-jitted JAX ``render_obs_ref`` on the same blocks;
* real: the masks remove most of the work.

Tolerance everywhere: exact (booleans and uint8 frames).

Inputs: the 8-env JAX fixture of tests/test_torch_rasterizer.py (validation
envs advanced 12 steps), seeded ego poses over all compiled towns with the
busiest segment cells first, and the fixture with every (cos, sin) row
scaled off the unit circle. Each runs with both ``left_handed`` values.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from test_torch_rasterizer import fixture_prep, fixture_states
from torchdriveenv_tpu.maps.arrays import load_assets as jload
from torchdriveenv_tpu.ops import rasterizer_pallas as jrp
from torchdriveenv_tpu_torch.maps.arrays import load_assets as tload
from torchdriveenv_tpu_torch.ops import _build
from torchdriveenv_tpu_torch.ops import rasterizer_cuda as trc

torch.set_num_threads(2)

RES, FOV, TILE = 64, 70.0, trc.CULL_TILE
N_TILES = (RES // TILE) ** 2
N_POSES = 32
# ceilings of the mean share of an env's listed segments that survive, on
# the inputs below (measured: 0.44 and 0.076 on the fixture, 0.36 and 0.045
# on the poses)
MAX_FRAME_SHARE = 0.55
MAX_TILE_SHARE = 0.12


@pytest.fixture(scope="module")
def jassets():
    return jload("val")


@pytest.fixture(scope="module")
def tassets():
    return tload("val", device="cpu")


def _fixture_batch(jassets):
    """(town, ci, cj, nseg, env, agent, wp) of the 8-env JAX fixture, packed
    by JAX's own prepare_obs_inputs."""
    st = fixture_states(jassets)
    return tuple(torch.from_numpy(x)
                 for x in (st.town, *fixture_prep(jassets, st)))


def _pose_batch(tassets, n=N_POSES, seed=0):
    """Seeded ego poses over the compiled towns: half in the cells with the
    most segments, half in random cells that hold road; agents and waypoints
    scattered up to 45 m around the ego, some out of sight, some absent."""
    maps = tassets.maps
    rng = np.random.default_rng(seed)
    counts = maps.seg_cell_n.numpy()
    order = np.argsort(-counts, axis=None, kind="stable")
    road_cells = order[: int((counts > 0).sum())]
    flat = np.concatenate([road_cells[: n // 2],
                           rng.choice(road_cells, n - n // 2, replace=False)])
    town, ci, cj = np.unravel_index(flat, counts.shape)
    cell = float(maps.seg_cell)
    ego_xy = (maps.origin.numpy()[town]
              + (np.stack([ci, cj], 1) + rng.random((n, 2))) * cell)
    n_agents, n_wp = 20, 10
    states = np.zeros((n, n_agents, 4), np.float32)
    states[..., :2] = ego_xy[:, None] + rng.uniform(-45, 45, (n, n_agents, 2))
    states[:, 0, :2] = ego_xy
    states[..., 2] = rng.uniform(-np.pi, np.pi, (n, n_agents))
    attrs = np.stack([rng.uniform(3.0, 6.0, (n, n_agents)),
                      rng.uniform(1.5, 2.5, (n, n_agents)),
                      np.full((n, n_agents), 1.4)], -1).astype(np.float32)
    present = rng.random((n, n_agents)) < 0.8
    present[:, 0] = True
    wps = (ego_xy[:, None] + rng.uniform(-45, 45, (n, n_wp, 2))
           ).astype(np.float32)
    town_t = torch.from_numpy(town.astype(np.int32))
    prep = trc.prepare_obs_inputs(
        maps, town_t, torch.from_numpy(rng.uniform(0, 60, n).astype(np.float32)),
        torch.from_numpy(states), torch.from_numpy(attrs),
        torch.from_numpy(present), torch.from_numpy(wps),
        torch.ones(n, dtype=torch.int32),
        torch.from_numpy(rng.integers(1, n_wp + 1, n).astype(np.int32)),
        fov=FOV)
    assert np.array_equal(prep[0].numpy(), ci) and np.array_equal(
        prep[1].numpy(), cj), "the egos sit in the cells they were drawn for"
    return (town_t, *prep)


def _off_unit_batch(batch):
    """The batch with the ego's and the boxes' (cos, sin) rows scaled off
    the unit circle: the frame and the boxes stretch, the cull must follow."""
    town, ci, cj, nseg, env, agent, wp = (x.clone() for x in batch)
    env[:, 0, 2:4] *= 1.3
    agent[:, ::2, 2:4] *= 0.6
    agent[:, 1::2, 2:4] *= 1.7
    return town, ci, cj, nseg, env, agent, wp


@pytest.fixture(scope="module")
def batches(tassets, jassets):
    fixture = _fixture_batch(jassets)
    return {"fixture": fixture, "poses": _pose_batch(tassets),
            "off_unit": _off_unit_batch(fixture)}


def _pixels(env_block, left_handed):
    idx = torch.arange(RES, dtype=torch.float32)
    img_row, img_col = torch.meshgrid(idx, idx, indexing="ij")
    return trc._pixel_world(env_block[:, 0], RES, FOV, left_handed,
                            img_row, img_col)


def _per_tile(hits):
    """(B, n, 64, 64) per-pixel hits -> (B, tiles, n) any pixel of the tile."""
    b, n = hits.shape[:2]
    side = RES // TILE
    t = hits.reshape(b, n, side, TILE, side, TILE).any(dim=5).any(dim=3)
    return t.reshape(b, n, N_TILES).transpose(1, 2)


def _listed_segments(tassets, batch):
    """The envs' segment rows, cut to the longest list of the batch."""
    town, ci, cj, nseg = batch[:4]
    seg = tassets.maps.seg_data[town.long(), ci.long(), cj.long()]
    k = max(int(nseg.max()), 1)
    assert (seg[:, k:, 4] < 0).all(), "rows past nseg never hit"
    return seg[:, :k]


def _dropped_hits(tassets, batch, left_handed, margin):
    """Number of (primitive, tile) and (segment, frame) pairs that the twin's
    exact test hits and the masks drop, by kind."""
    town, ci, cj, nseg, env, agent, wp = batch
    masks = trc.cull_masks_torch(tassets.maps, *batch, res=RES, fov=FOV,
                                 left_handed=left_handed, margin=margin)
    px, py = _pixels(env, left_handed)
    seg = _listed_segments(tassets, batch)
    k = seg.shape[1]
    dropped = dict(frame=0, seg=0)
    for b0 in range(0, town.shape[0], 8):        # bounds the (B, K, 64, 64)
        sl = slice(b0, b0 + 8)
        hits = trc._seg_hits(seg[sl], px[sl], py[sl])
        dropped["frame"] += int((hits.any(dim=3).any(dim=2)
                                 & ~masks.frame[sl, :k]).sum())
        dropped["seg"] += int((_per_tile(hits) & ~masks.seg[sl, :, :k]).sum())
    dropped["agent"] = int((_per_tile(trc._obb_hits(agent, px, py))
                            & ~masks.agent).sum())
    dropped["wp"] = int((_per_tile(trc._wp_hits(wp, px, py)) & ~masks.wp).sum())
    sl_hits = torch.stack(trc._stopline_hits(env, px, py), dim=1)
    dropped["stopline"] = int((_per_tile(sl_hits) & ~masks.stopline).sum())
    ego_hits = trc._ego_hit(env[:, 0], px, py)[:, None]
    dropped["ego"] = int((_per_tile(ego_hits)[..., 0] & ~masks.ego).sum())
    return dropped, masks


CASES = [(name, lh) for name in ("fixture", "poses", "off_unit")
         for lh in (True, False)]


@pytest.mark.parametrize("name,left_handed", CASES)
def test_cull_never_drops_a_hit(tassets, batches, name, left_handed):
    dropped, masks = _dropped_hits(tassets, batches[name], left_handed,
                                   trc.CULL_MARGIN)
    assert dropped == dict(frame=0, seg=0, agent=0, wp=0, stopline=0, ego=0)
    # the inputs exercise every kind of primitive
    assert masks.seg.any() and masks.agent.any() and masks.ego.any()
    assert masks.wp.any() and masks.stopline.any()


@pytest.mark.parametrize("name,left_handed", CASES)
def test_cull_margin_has_slack(tassets, batches, name, left_handed):
    """With a fifth of the margin the predicates still drop no hit: the
    other four fifths (0.2 m) cover what the kernel's own rounding of the
    cull arithmetic can differ from this plain version's (about 1e-4 m)."""
    dropped, _ = _dropped_hits(tassets, batches[name], left_handed,
                               trc.CULL_MARGIN / 5)
    assert not any(dropped.values()), dropped


def _culled_render(tassets, batch, left_handed, highlight_ego):
    """The frame assembled tile by tile: each tile sees only the primitives
    its masks keep, through the twin's own pixel functions."""
    town, ci, cj, nseg, env, agent, wp = batch
    masks = trc.cull_masks_torch(tassets.maps, *batch, res=RES, fov=FOV,
                                 left_handed=left_handed)
    px, py = _pixels(env, left_handed)
    seg = _listed_segments(tassets, batch)
    k = seg.shape[1]
    never = torch.tensor(-1.0)
    out = torch.zeros(town.shape[0], 3, RES, RES, dtype=torch.uint8)
    for tile in range(N_TILES):
        r0, c0 = tile // (RES // TILE) * TILE, tile % (RES // TILE) * TILE
        tpx = px[:, r0:r0 + TILE, c0:c0 + TILE]
        tpy = py[:, r0:r0 + TILE, c0:c0 + TILE]
        seg_t = seg.clone()
        seg_t[..., 4] = torch.where(masks.seg[:, tile, :k], seg[..., 4], never)
        road = torch.zeros(tpx.shape, dtype=torch.bool)
        for s0 in range(0, k, trc.SEG_CHUNK):
            road |= trc._seg_chunk_hit(seg_t[:, s0:s0 + trc.SEG_CHUNK], tpx, tpy)
        agent_t, wp_t, env_t = agent.clone(), wp.clone(), env.clone()
        agent_t[..., 6] *= masks.agent[:, tile]
        wp_t[..., 2] *= masks.wp[:, tile]
        env_t[:, 2:6, 7] *= masks.stopline[:, tile]
        env_t[:, 0, 4:6] = torch.where(masks.ego[:, tile, None],
                                       env[:, 0, 4:6], never)
        chans = trc._composite(tpx, tpy, road, env_t, agent_t, wp_t,
                               highlight_ego)
        out[:, :, r0:r0 + TILE, c0:c0 + TILE] = torch.stack(
            chans, dim=1).to(torch.uint8)
    return out


@pytest.mark.parametrize("name,left_handed", CASES)
def test_culled_render_equals_twin(tassets, batches, name, left_handed):
    batch = batches[name]
    highlight_ego = left_handed          # both values, one per handedness
    want = trc.render_obs_torch(tassets.maps, *batch, res=RES, fov=FOV,
                                left_handed=left_handed,
                                highlight_ego=highlight_ego)
    got = _culled_render(tassets, batch, left_handed, highlight_ego)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)
    assert (want != want[:, :, :1, :1]).any(), "the frames are not blank"


@pytest.mark.parametrize("left_handed", [True, False])
def test_culled_render_equals_jax_render_obs_ref(tassets, jassets, batches,
                                                 left_handed):
    batch = batches["fixture"]
    want = np.asarray(jax.vmap(
        lambda *a: jrp.render_obs_ref(jassets.maps, *a, res=RES, fov=FOV,
                                      left_handed=left_handed))(
        *[x.numpy() for x in batch]))
    got = _culled_render(tassets, batch, left_handed, True).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["fixture", "poses"])
def test_cull_removes_work(tassets, batches, name):
    """A cull that keeps everything fails: per env, the mean share of the
    listed segments that reach the frame, and that reach a tile."""
    batch = batches[name]
    masks = trc.cull_masks_torch(tassets.maps, *batch, res=RES, fov=FOV)
    nseg = batch[3].float()
    assert (nseg > 0).all()
    frame_share = (masks.frame.sum(1) / nseg).mean()
    tile_share = (masks.seg.sum(2).float().mean(1) / nseg).mean()
    assert frame_share < MAX_FRAME_SHARE, float(frame_share)
    assert tile_share < MAX_TILE_SHARE, float(tile_share)
    assert tile_share < frame_share
    # overlays: most tiles see few of the boxes and discs that are in sight
    present = (batch[5][..., 6] > 0).sum(1).float()
    seen = masks.agent.sum(2).float().mean(1)
    assert (seen[present > 0] / present[present > 0]).mean() < 0.5
    assert masks.ego.float().mean() < 0.5


def test_cull_constants_match_the_cuda_source():
    with open(os.path.join(_build.CSRC_DIR, "rasterizer.cu")) as f:
        src = f.read()
    margin = re.search(r"kCullMargin = ([0-9.]+)f;", src)
    tile = re.search(r"kTile = (\d+);", src)
    assert float(margin.group(1)) == trc.CULL_MARGIN
    assert int(tile.group(1)) == trc.CULL_TILE
    assert trc.KERNEL_RES % trc.CULL_TILE == 0
    # the source holds the one kernel the package launches
    assert src.count("__global__") == 1 and "tde_render_obs(" in src
    with open(trc.__file__) as f:
        py = f.read()
    dispatcher = py[py.index("def render_observation("):]
    assert "fullscan" not in dispatcher and "cull_masks" not in dispatcher
