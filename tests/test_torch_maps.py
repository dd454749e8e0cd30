"""The port's asset loader and map samplers against the JAX package.

Samplers run on the same 4096 points per town (inside and outside the
grid), made with numpy from a fixed seed; the JAX side runs un-jitted.
Nearest-neighbor samplers, the SDF gradient and the packed NPC field are
gathers plus elementwise arithmetic, so they must match exactly; the
bilinear SDF sample is held to 1e-6.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torchdriveenv_tpu.maps import arrays as jarr
from torchdriveenv_tpu_torch.maps import arrays as tarr

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def jassets():
    return jarr.load_assets("val")


@pytest.fixture(scope="module")
def tassets():
    return tarr.load_assets("val", device="cpu")


def _points(maps_np, town, n=4096, seed=0):
    rng = np.random.default_rng(seed + town)
    g = maps_np["sdf"].shape[-1]
    span = g * float(maps_np["scale"])
    lo = maps_np["origin"][town] - 0.1 * span
    return (lo + rng.uniform(0.0, 1.2 * span, size=(n, 2))).astype(np.float32)


@pytest.mark.parametrize("town", range(5))
def test_samplers_match_jax(jassets, tassets, town):
    maps_np = {"sdf": np.asarray(jassets.maps.sdf),
               "scale": np.asarray(jassets.maps.scale),
               "origin": np.asarray(jassets.maps.origin)}
    xy = _points(maps_np, town)
    jm, tm = jassets.maps, tassets.maps
    jt, tt = jnp.int32(town), torch.tensor(town, dtype=torch.int32)
    jxy, txy = jnp.asarray(xy), torch.from_numpy(xy)

    exact = {
        "sdf_nearest": (jarr.sample_sdf_nearest(jm, jt, jxy),
                        tarr.sample_sdf_nearest(tm, tt, txy)),
        "dir_angle": (jarr.sample_dir_angle(jm, jt, jxy),
                      tarr.sample_dir_angle(tm, tt, txy)),
    }
    for name, jv, tv in zip(("gx", "gy"), jarr.sample_sdf_grad(jm, jt, jxy),
                            tarr.sample_sdf_grad(tm, tt, txy)):
        exact[f"sdf_grad_{name}"] = (jv, tv)
    for name, jv, tv in zip(("dir", "gx", "gy"),
                            jarr.sample_npc_field(jm, jt, jxy),
                            tarr.sample_npc_field(tm, tt, txy)):
        exact[f"npc_field_{name}"] = (jv, tv)
    for name, (jv, tv) in exact.items():
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)

    np.testing.assert_allclose(tarr.sample_sdf(tm, tt, txy).numpy(),
                               np.asarray(jarr.sample_sdf(jm, jt, jxy)),
                               atol=1e-6, rtol=0)


def test_samplers_broadcast_one_town_per_env(jassets, tassets):
    """A (B,) town vector broadcasts over each env's points, as vmap does."""
    rng = np.random.default_rng(1)
    towns = np.array([0, 3, 4, 1], np.int32)
    maps_np = {"sdf": np.asarray(jassets.maps.sdf),
               "scale": np.asarray(jassets.maps.scale),
               "origin": np.asarray(jassets.maps.origin)}
    xy = np.stack([_points(maps_np, int(t), n=64, seed=int(rng.integers(99)))
                   for t in towns]).reshape(4, 8, 8, 2)
    got = tarr.sample_dir_angle(tassets.maps, torch.from_numpy(towns),
                                torch.from_numpy(xy)).numpy()
    for i, t in enumerate(towns):
        want = jarr.sample_dir_angle(jassets.maps, jnp.int32(t),
                                     jnp.asarray(xy[i]))
        np.testing.assert_array_equal(got[i], np.asarray(want))


def _np_dtype(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


@pytest.mark.parametrize("suite", ["val", "train"])
def test_load_assets_dtypes_and_shapes(suite):
    ja = jarr.load_assets(suite)
    ta = tarr.load_assets(suite, device="cpu")
    for group in ("maps", "suite", "background"):
        jg, tg = getattr(ja, group), getattr(ta, group)
        for name in type(tg).__dataclass_fields__:
            jv, tv = getattr(jg, name), getattr(tg, name)
            assert tuple(tv.shape) == tuple(jv.shape), (group, name)
            if name == "npc_field":
                # uint32 on the JAX side; int64 here (torch's uint32 lacks
                # the shift/mask ops), with the same values
                assert tv.dtype == torch.int64
            else:
                assert _np_dtype(tv) == _np_dtype(jv), (group, name)
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv),
                                          err_msg=f"{group}.{name}")


def test_rows_past_cell_count_never_hit(tassets):
    """The kernel scans exactly seg_cell_n rows per cell; that equals the
    twin's full scan because every row past the count has a negative
    sign(hw)*hw^2 threshold."""
    seg = tassets.maps.seg_data
    n = tassets.maps.seg_cell_n
    rows = torch.arange(seg.shape[3])
    past = rows[None, None, None, :] >= n[..., None].long()
    assert (seg[..., 4][past] < 0).all()


def test_load_assets_without_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tarr.load_assets("val")
