"""CLI of the offline asset compiler (port of ``tools/compile_assets.py``;
the logic lives in ``maps/compile.py``, so a program can also compile its
own data).

Reads a reference checkout's waypoint suites
(``torchdriveenv/data/{training,validation}_cases.yml``) and background
traffic caches (``torchdriveenv/resources/background_traffic/*.json``) and
writes the four bundles ``load_assets(assets_dir=...)`` reads:
``maps_v1.npz``, ``suite_train_v1.npz``, ``suite_val_v1.npz`` and
``background_v1.npz``, with the JAX CLI's keys and dtypes. The grid passes
run on ``--device`` (default: the GPU, through the kernels of
``csrc/mapkit.cu``).

    python -m torchdriveenv_tpu_torch.tools.compile_assets \\
        --reference <checkout> --out <dir> [--device cpu]

``--reference`` is required. ``--out`` defaults to
``torchdriveenv_tpu_torch/build/assets/``; the package never writes into
the JAX package's ``assets/``.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from torchdriveenv_tpu_torch.maps import compile as mc
from torchdriveenv_tpu_torch.maps.arrays import resolve_device
from torchdriveenv_tpu_torch.utils.precision import set_f32_precision

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(_PKG, "build", "assets")
FILES = ("maps_v1.npz", "suite_train_v1.npz", "suite_val_v1.npz",
         "background_v1.npz")


def _quantize(g: torch.Tensor) -> torch.Tensor:
    """An SDF gradient as the uint8 of the packed field: round(g * 32) +
    128, clipped to 0..255 (round half to even, as numpy's)."""
    return torch.clamp(torch.round(g * 32.0) + 128, 0, 255).to(torch.int64)


def compile_town(suites, background, town: str,
                 device=None) -> Dict[str, np.ndarray]:
    """One town's entries of ``maps_v1.npz`` (numpy, the bundle's dtypes):
    the grids on ``device``, the lights and the corridor content on the
    host."""
    dev = resolve_device(device)
    segs, pts, render_segs = mc.town_content(suites, background, town)
    origin, sdf, dirs = mc.compile_town_map(segs, pts, device=dev)
    # SDF gradient (unit-ish) for one-gather road-edge steering
    gx, gy = torch.gradient(sdf, spacing=mc.SCALE)
    # packed NPC control field: ONE gather yields (dir f16, gx u8, gy u8)
    dir16 = dirs.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
    npc = dir16 | (_quantize(gx) << 16) | (_quantize(gy) << 24)

    def host(t):
        return t.cpu().numpy()

    out = dict(
        origin=origin,
        sdf=host(sdf.to(torch.float16)),
        dir_angle=host(dirs.to(torch.float16)),
        sdf_gx=host(torch.clamp(gx, -1.5, 1.5).to(torch.float16)),
        sdf_gy=host(torch.clamp(gy, -1.5, 1.5).to(torch.float16)),
        npc_field=host(npc).astype(np.uint32),
    )
    seg_idx, k_max = mc.compile_segment_index(render_segs, origin, device=dev)
    out.update({k: host(v) for k, v in seg_idx.items()})
    lights, nl = mc.synthesize_lights(suites, town)
    out.update(lights)
    drv = float((sdf > 0).double().mean())
    mc.log(f"{town}: {len(segs)} segments, drivable {drv:.1%}, {nl} lights, "
           f"seg-index kmax {k_max}, origin {origin}")
    return out


def compile_assets(suites, background, out: str, device=None) -> str:
    """Compile ``suites`` ({"train": ..., "val": ...} waypoint-suite dicts)
    and ``background`` ({town: [cache json, ...]}) into the four bundles
    under ``out``. Returns ``out``."""
    t_n, g = len(mc.TOWNS), mc.GRID
    maps = dict(
        scale=np.float32(mc.SCALE),
        origin=np.zeros((t_n, 2), np.float32),
        sdf=np.zeros((t_n, g, g), np.float16),
        dir_angle=np.zeros((t_n, g, g), np.float16),
        sdf_gx=np.zeros((t_n, g, g), np.float16),
        sdf_gy=np.zeros((t_n, g, g), np.float16),
        npc_field=np.zeros((t_n, g, g), np.uint32),
        stop_p0=np.zeros((t_n, mc.MAX_LIGHTS, 2), np.float32),
        stop_p1=np.zeros((t_n, mc.MAX_LIGHTS, 2), np.float32),
        stop_dir=np.zeros((t_n, mc.MAX_LIGHTS), np.float32),
        light_phase=np.zeros((t_n, mc.MAX_LIGHTS), np.float32),
        light_mask=np.zeros((t_n, mc.MAX_LIGHTS), bool),
        light_durations=np.asarray(
            [mc.LIGHT_GREEN, mc.LIGHT_YELLOW, mc.LIGHT_RED], np.float32),
        seg_data=np.zeros((t_n, mc.SEG_GRID, mc.SEG_GRID, mc.SEG_K,
                           mc.SEG_F), np.float32),
        seg_cell=np.float32(mc.SEG_CELL),
        seg_cell_n=np.zeros((t_n, mc.SEG_GRID, mc.SEG_GRID), np.int32),
    )
    maps["seg_data"][..., 4] = -1.0
    for ti, town in enumerate(mc.TOWNS):
        for k, v in compile_town(suites, background, town, device).items():
            maps[k][ti] = v
    os.makedirs(out, exist_ok=True)
    np.savez_compressed(os.path.join(out, "maps_v1.npz"),
                        town_names=np.array(mc.TOWNS), **maps)
    for name in ("train", "val"):
        np.savez_compressed(os.path.join(out, f"suite_{name}_v1.npz"),
                            **mc.compile_suite(suites[name]))
    np.savez_compressed(os.path.join(out, "background_v1.npz"),
                        **mc.compile_background(background))
    for fn in FILES:
        p = os.path.join(out, fn)
        mc.log(f"{fn}: {os.path.getsize(p) / 1e6:.2f} MB")
    return out


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reference", required=True,
                    help="a reference checkout (its torchdriveenv/data and "
                         "torchdriveenv/resources/background_traffic)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="directory of the four bundles")
    ap.add_argument("--device", default=None,
                    help="device of the grid passes (default: the GPU)")
    args = ap.parse_args(argv)
    set_f32_precision()
    suites = mc.load_suites(args.reference)
    background = mc.load_background(args.reference)
    return compile_assets(suites, background, args.out, device=args.device)


if __name__ == "__main__":
    main()
