"""The env step's least-work counts (``torchdriveenv_tpu_torch/bench.py``)
on the CPU.

``phase_costs`` counts each phase's least bytes and operations from shapes
and from the inputs. Here the bytes are held to hand sums of the tensors
the step and the reset really read, gather and write, the counts to
linearity in the batch, the render's operations to a brute-force count
over the kernel's culls (``cull_masks_torch``), and the roofline to its
arithmetic on fixed times.
"""

import dataclasses

import pytest
import torch

from torchdriveenv_tpu_torch import bench
from torchdriveenv_tpu_torch.config import EnvConfig
from torchdriveenv_tpu_torch.env import core
from torchdriveenv_tpu_torch.env.batched import BatchedEnv
from torchdriveenv_tpu_torch.maps.arrays import load_assets
from torchdriveenv_tpu_torch.npc.policy_net import default_params
from torchdriveenv_tpu_torch.ops import rasterizer_cuda as rc

torch.set_num_threads(2)
ACT = (0.3, 0.0)
_ASSETS = {}


def _assets():
    if "val" not in _ASSETS:
        _ASSETS["val"] = load_assets("val", device="cpu")
    return _ASSETS["val"]


def _stepped(cfg, b, seed=2):
    """A batch of ``b`` envs after one step."""
    env = BatchedEnv(cfg, _assets(), b, device="cpu", seed=seed)
    state, _ = env.reset()
    return env.step(state, torch.tensor([ACT]).repeat(b, 1)).state


def _fixed_reads(cfg):
    """What a step reads once whatever the batch: the light durations, the
    map scale, and in policy mode the GRU's weights."""
    maps = _assets().maps
    once = maps.light_durations.nbytes + maps.scale.nbytes
    if cfg.npc_mode == "policy":
        once += sum(p.nbytes for p in default_params("cpu").parameters())
    return once


@pytest.mark.parametrize("mode", ["route", "policy"])
def test_physics_bytes_are_a_hand_sum_of_the_tensors(mode):
    """Every state field and the actions read, the gathered map, light,
    replay and waypoint elements, the step's new fields, reward, flags and
    infos written: the sum of those tensors' ``nbytes`` at B = 4."""
    cfg = EnvConfig(npc_mode=mode)
    assets, b = _assets(), 4
    maps, suite = assets.maps, assets.suite
    state = _stepped(cfg, b)
    assert (state.npc_hidden is None) == (mode == "route")
    act = torch.tensor([ACT]).repeat(b, 1)
    npc = default_params("cpu") if mode == "policy" else None
    nxt, reward, term, trunc, info = core.step(cfg, assets, state, act,
                                               npc_params=npc)
    names = [f.name for f in dataclasses.fields(state)]
    read = sum(getattr(state, k).nbytes for k in names
               if getattr(state, k) is not None) + act.nbytes
    tw, case = state.town.long(), state.case.long()
    a = state.present.shape[1]
    gathered = (maps.npc_field[tw[:, None].expand(b, a), 0, 0].nbytes
                + maps.sdf[tw, :4, :4].nbytes + maps.origin[tw].nbytes
                + sum(x[tw].nbytes for x in (maps.stop_p0, maps.stop_p1,
                                             maps.stop_dir, maps.light_phase,
                                             maps.light_mask))
                + suite.replay_states[case, :, 0].nbytes
                + suite.replay_mask[case, :, 0].nbytes
                + suite.waypoints[case, 0].nbytes
                + suite.n_waypoints[case].nbytes)
    written = (sum(getattr(nxt, k).nbytes for k in names
                   if getattr(nxt, k) is not None
                   and getattr(nxt, k) is not getattr(state, k))
               + reward.nbytes + term.nbytes + trunc.nbytes
               + sum(v.nbytes for v in info.values()))
    want = read + gathered + written + _fixed_reads(cfg)
    assert bench.physics_cost(cfg, assets, state, npc)["bytes"] == want


@pytest.mark.parametrize("mode", ["route", "policy"])
def test_physics_costs_are_linear_in_the_batch(mode):
    cfg = EnvConfig(npc_mode=mode)
    state4 = _stepped(cfg, 4)
    state2 = state4.take(torch.arange(2))
    c2 = bench.physics_cost(cfg, _assets(), state2)
    c4 = bench.physics_cost(cfg, _assets(), state4)
    assert c4["flops"] == 2 * c2["flops"] > 0
    once = _fixed_reads(cfg)
    assert c4["bytes"] - once == 2 * (c2["bytes"] - once) > 0


def test_autoreset_bytes_are_a_hand_sum_of_the_tensors():
    """A pool of 2 fresh states for 4 envs, all done: the pool's draws and
    states written, the suite, background and map elements a reset
    gathers, the next state and done flags read, a pool row read and a row
    written for every env."""
    cfg = EnvConfig(reset_pool=2)
    assets, b = _assets(), 4
    maps, suite, bg = assets.maps, assets.suite, assets.background
    state = _stepped(cfg, b)
    gen = torch.Generator().manual_seed(1)
    draws = core.sample_reset_draws(2, gen, assets, cfg)
    pool = core.reset_from_draws(cfg, assets, draws)
    row = bench._nbytes(state) // b
    case, bg_file = draws.case.long(), draws.bg_file.long()
    tw = suite.case_town[case].long()
    tail = state.present.shape[1] - 1 - suite.scen_states.shape[1]
    n_spawn = draws.spawn_psi_n.shape[1]
    sdf, gx, gy, heading = (x[0, 0, 0].nbytes for x in (
        maps.sdf, maps.sdf_gx, maps.sdf_gy, maps.dir_angle))
    # a spawn candidate: two projections (an SDF value and its gradient),
    # then its SDF value and its heading
    per_candidate = 2 * (sdf + gx + gy) + sdf + heading
    gathered = (suite.case_town[case].nbytes + suite.waypoints[case, :2].nbytes
                + maps.origin[tw].nbytes + maps.dir_angle[tw, 0, 0].nbytes
                + bg.bg_valid[tw].nbytes + suite.scen_states[case].nbytes
                + suite.scen_attrs[case].nbytes + suite.scen_mask[case].nbytes
                + bg.bg_states[tw, bg_file, :tail].nbytes
                + bg.bg_attrs[tw, bg_file, :tail].nbytes
                + bg.bg_mask[tw, bg_file, :tail].nbytes
                + bg.bg_density[tw, bg_file].nbytes
                + 2 * n_spawn * per_candidate)
    done = torch.ones(b, dtype=torch.bool)
    want = (bench._nbytes(draws) + gathered + bench._nbytes(pool)
            + maps.light_durations.nbytes
            + bench._nbytes(state) + done.nbytes + b * row + b * row)
    assert bench.autoreset_cost(cfg, assets, state)["bytes"] == want


def test_render_cost_counts_what_survives_the_culls():
    """At B = 2: the operations equal a count over every (env, tile) of the
    segments and primitives ``cull_masks_torch`` keeps, and are no more
    than a scan of every listed segment; the bytes are the distinct cells'
    segment rows, the kernel's inputs and the frames."""
    cfg = EnvConfig()
    assets = _assets()
    maps = assets.maps
    state = _stepped(cfg, 4).take(torch.arange(2))
    prep = bench.render_inputs(cfg, assets, state)
    cost = rc.render_cost(maps, state.town, *prep)
    m = rc.cull_masks_torch(maps, state.town, *prep)
    tile_px = rc.CULL_TILE * rc.CULL_TILE
    brute = 0
    for e in range(2):
        for t in range(m.seg.shape[1]):
            brute += tile_px * (
                rc.PIXEL_CENTRE_OPS + rc.SELECT_OPS
                + rc.ROAD_OPS * int(m.seg[e, t].sum())
                + rc.DISC_OPS * int(m.wp[e, t].sum())
                + rc.BOX_OPS * int(m.agent[e, t].sum())
                + rc.STOPLINE_OPS * int(m.stopline[e, t].sum())
                + rc.EGO_BOX_OPS * int(m.ego[e, t]))
    assert cost["flops"] == brute
    nseg = prep[2]
    assert cost["flops_scan_all"] == 64 * 64 * (
        rc.ROAD_OPS * int(nseg.sum()) + 2 * rc.COMPOSITE_OPS)
    assert 0 < cost["flops"] <= cost["flops_scan_all"]
    cells = {(int(t), int(i), int(j))
             for t, i, j in zip(state.town, prep[0], prep[1])}
    frames = rc.render_obs_torch(maps, state.town, *prep)
    assert cost["bytes"] == (
        sum(int(maps.seg_cell_n[c]) for c in cells)
        * maps.seg_data[0, 0, 0, 0].nbytes
        + sum(x.nbytes for x in (state.town, *prep)) + frames.nbytes)


@pytest.mark.parametrize("flops, nbytes, bound_by", [
    (67e9, 3.35e8, "operations"), (6.7e9, 3.35e9, "bytes")])
def test_roofline_arithmetic(flops, nbytes, bound_by):
    """Physics and render count whole, the all-done auto-reset by the
    share of envs done; the shares are the least times over the step."""
    costs = {"physics": {"flops": flops, "bytes": nbytes},
             "render": {"flops": 2 * flops, "bytes": 2 * nbytes},
             "autoreset_pool_all_done": {"flops": 10 * flops,
                                         "bytes": 10 * nbytes}}
    r = bench.roofline(costs, per_step_s=0.01, done_share=0.1)
    step_flops, step_bytes = 4 * flops, 4 * nbytes
    t_ops, t_bytes = step_flops / 67e12, step_bytes / 3.35e12
    assert r["flops_per_step"] == pytest.approx(step_flops, rel=1e-12)
    assert r["bytes_per_step"] == pytest.approx(step_bytes, rel=1e-12)
    assert r["flops_utilization_vs_f32_peak"] == pytest.approx(
        t_ops / 0.01, rel=1e-12)
    assert r["hbm_bw_utilization"] == pytest.approx(t_bytes / 0.01,
                                                    rel=1e-12)
    assert r["least_ms_per_step"] == pytest.approx(
        max(t_ops, t_bytes) * 1e3, rel=1e-12)
    assert r["bound_by"] == bound_by
    assert r["phases_least_ms"]["render"] == pytest.approx(
        2 * max(flops / 67e12, nbytes / 3.35e12) * 1e3, rel=1e-12)
