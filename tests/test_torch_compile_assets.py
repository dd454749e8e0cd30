"""The port's asset CLI (``torchdriveenv_tpu_torch/tools/compile_assets.py``)
against the JAX CLI (``tools/compile_assets.py``), end to end.

A reference-layout directory is written from the shipped bundles
(``torchdriveenv/data/{training,validation}_cases.yml`` and
``torchdriveenv/resources/background_traffic/*.json``); both CLIs compile
it, with ``GRID`` patched to 256 in both compilers so that the run stays
short, the JAX one with its native library off (no g++) and the port's
with ``--device cpu``. All four files must hold the same keys, dtypes and
values, bit for bit, except ``dir_angle`` and the low 16 bits of
``npc_field`` (the direction's float16), where at most a 5e-3 share of
pixels may differ: scipy breaks equidistant ties its own way.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from test_torch_map_compile import ROOT, compiler_inputs
from torchdriveenv_tpu.maps import compile as jmc
from torchdriveenv_tpu.maps import native as jnative
from torchdriveenv_tpu_torch.maps import compile as tmc
from torchdriveenv_tpu_torch.tools import compile_assets as tca

torch.set_num_threads(2)
SMALL_GRID = 256


def write_reference(root, suites, background):
    """The reference checkout's layout, holding ``suites`` and
    ``background``; the cache files are named so that each town's caches
    list in order."""
    data = os.path.join(root, "torchdriveenv", "data")
    bg_dir = os.path.join(root, "torchdriveenv", "resources",
                          "background_traffic")
    os.makedirs(data)
    os.makedirs(bg_dir)
    for name, fn in (("train", "training_cases.yml"),
                     ("val", "validation_cases.yml")):
        with open(os.path.join(data, fn), "w") as f:
            yaml.safe_dump(suites[name], f)
    for town, caches in background.items():
        for k, cache in enumerate(caches):
            with open(os.path.join(bg_dir, f"{town}_{k:02d}.json"), "w") as f:
                json.dump(cache, f)
    return root


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "jax_compile_assets", os.path.join(ROOT, "tools", "compile_assets.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """(JAX out dir, port out dir, reference dir) at GRID 256."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jnative, "available", lambda: False)
        mp.setattr(jmc, "GRID", SMALL_GRID)
        mp.setattr(tmc, "GRID", SMALL_GRID)
        tmp = tmp_path_factory.mktemp("compile_assets")
        ref = write_reference(str(tmp / "reference"), *compiler_inputs())
        jout, tout = str(tmp / "jax"), str(tmp / "port")
        mp.setattr(sys, "argv", ["compile_assets.py", "--reference", ref,
                                 "--out", jout])
        _jax_cli().main()
        assert tca.main(["--reference", ref, "--out", tout,
                         "--device", "cpu"]) == tout
    finally:
        mp.undo()
    return jout, tout, ref


@pytest.mark.parametrize("fn", tca.FILES)
def test_cli_files_match_jax(compiled, fn):
    jout, tout, _ = compiled
    want, got = np.load(os.path.join(jout, fn)), np.load(os.path.join(tout, fn))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "dir_angle":
            assert (g != w).mean() <= 5e-3, k
        elif k == "npc_field":
            np.testing.assert_array_equal(g >> 16, w >> 16, err_msg=k)
            assert ((g & 0xFFFF) != (w & 0xFFFF)).mean() <= 5e-3, k
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    if fn == "maps_v1.npz":
        assert got["sdf"].shape == (len(tmc.TOWNS), SMALL_GRID, SMALL_GRID)
        assert (got["sdf"] > 0).any() and (got["sdf"] < 0).any()


def test_cli_loads_the_reference_layout(compiled):
    _, _, ref = compiled
    suites, background = tmc.load_suites(ref), tmc.load_background(ref)
    want_s, want_b = compiler_inputs()
    assert suites == want_s and background == want_b
    assert suites == jmc.load_suites(ref)
    assert background == jmc.load_background(ref)


def test_cli_defaults():
    """``--out`` lands in the port's git-ignored build directory, never in
    the JAX package's assets; ``--reference`` has no default."""
    assert tca.DEFAULT_OUT == os.path.join(ROOT, "torchdriveenv_tpu_torch",
                                           "build", "assets")
    with pytest.raises(SystemExit):
        tca.main(["--out", tca.DEFAULT_OUT])
