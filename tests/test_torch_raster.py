"""Port parity: binning plus Kernel A's plain version (sgs_tpu_torch.render
.tiled, sgs_tpu_torch.ops.flat_raster) against the JAX tiled rasterizer
with the Pallas backend and tight culling, which on the CPU runs the Pallas
kernel in interpret mode. Images to atol 3e-5, the package's parity bar."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgs_tpu.render import tiled as jtiled
from sgs_tpu.render.tiled import instance_count_tight, rasterize_tiled, row_count
from sgs_tpu_torch.core.projection import TILE
from sgs_tpu_torch.ops import flat_raster
from sgs_tpu_torch.render import tiled

torch.set_num_threads(1)
ATOL = 3e-5


def _scene(seed, n, w, h):
    """Random 2-D Gaussians with an empty corner tile and a stack of
    opaque splats that saturates one tile; includes opacities below 1/255
    and invalid entries."""
    rng = np.random.default_rng(seed)
    mean2d = rng.uniform(-8, [w + 8, h + 8], (n, 2))
    l1 = rng.uniform(0.005, 0.5, n)
    l2 = rng.uniform(0.005, 0.5, n)
    n_stack = 24
    mean2d[:n_stack] = [TILE + 8.0, TILE + 8.0] + rng.uniform(-2, 2, (n_stack, 2))
    l1[:n_stack] = l2[:n_stack] = 0.03
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    conic = np.stack([l1 * c * c + l2 * s * s, (l1 - l2) * s * c, l1 * s * s + l2 * c * c], 1)
    opac = rng.uniform(0.001, 0.99, n)
    opac[:n_stack] = 0.97
    radius = np.ceil(3.0 / np.sqrt(np.minimum(l1, l2))).astype(np.int32)
    valid = rng.uniform(size=n) > 0.1
    # keep the last tile empty: nothing whose rect reaches it
    tiles_x, tiles_y = -(-w // TILE), -(-h // TILE)
    far_x = (mean2d[:, 0] + radius + TILE - 1) // TILE >= tiles_x
    far_y = (mean2d[:, 1] + radius + TILE - 1) // TILE >= tiles_y
    valid &= ~(far_x & far_y)
    return dict(
        mean2d=mean2d.astype(np.float32), depth=rng.uniform(0.5, 10.0, n).astype(np.float32),
        conic=conic.astype(np.float32), rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
        opacity=opac.astype(np.float32), radius=radius, valid=valid,
        bg=rng.uniform(0, 1, 3).astype(np.float32),
    )


def _torch(sc):
    return {k: torch.from_numpy(np.array(v)) for k, v in sc.items()}


def _port_image(sc, w, h):
    t = _torch(sc)
    return tiled.rasterize_tiled(
        t["mean2d"], t["depth"], t["conic"], t["rgb"], t["opacity"], t["radius"],
        t["valid"], t["bg"], w, h,
    )


def _port_composite(sc, w, h, tight):
    """Bin with or without tight culling and composite with Kernel A's
    plain version: (color, t_final, n_contrib, instance count)."""
    t = _torch(sc)
    bins = tiled.bin_gaussians(t["mean2d"], t["conic"], t["opacity"], t["depth"], t["radius"],
                               t["valid"], w, h, tight)
    out = flat_raster.rasterize_tiles(
        *tiled.kernel_args(bins, t["mean2d"], t["conic"], t["opacity"], t["rgb"], w, h)
    )
    return out + (bins["point_list"].shape[0],)


def _jax_image(sc, w, h):
    j = {k: jnp.asarray(v) for k, v in sc.items()}
    rc = int(row_count(j["mean2d"], j["radius"], j["valid"], w, h)) + 16
    ti = int(instance_count_tight(
        j["mean2d"], j["conic"], j["opacity"], j["depth"], j["radius"], j["valid"], w, h, rc
    ))
    img, ovf = rasterize_tiled(
        j["mean2d"], j["depth"], j["conic"], j["rgb"], j["opacity"], j["radius"], j["valid"],
        j["bg"], w, h, max_instances=-(-ti // 256) * 256 + 256, backend="pallas",
        max_row_instances=rc,
    )
    assert int(ovf) == 0
    return np.asarray(img), ti


@pytest.mark.parametrize("w,h,seed", [(64, 48, 0), (70, 33, 1)])
def test_image_matches_jax_pallas(w, h, seed):
    sc = _scene(seed, 300, w, h)
    img, aux = _port_image(sc, w, h)
    want, jax_instances = _jax_image(sc, w, h)
    assert aux["n_instances"] == jax_instances
    bins = aux["bins"]
    counts = (bins["tile_end"] - bins["tile_start"]).numpy()
    assert (counts == 0).any(), "scene should hold an empty tile"
    # the stacked tile saturates: its centre stops before the end of the list
    centre = aux["n_contrib"][TILE + 8, TILE + 8]
    assert 0 < int(centre) < counts[bins["tiles_x"] + 1]
    assert float(aux["t_final"][TILE + 8, TILE + 8]) < 1e-2
    assert img.shape == (3, h, w)
    np.testing.assert_allclose(img.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", [2, 3])
def test_tight_culling_keeps_the_image(seed):
    w, h = 96, 80
    sc = _scene(seed, 400, w, h)
    col_t, tf_t, _, n_t = _port_composite(sc, w, h, tight=True)
    col_r, tf_r, _, n_r = _port_composite(sc, w, h, tight=False)
    assert 0 < n_t < n_r
    np.testing.assert_array_equal(col_t.numpy(), col_r.numpy())
    np.testing.assert_array_equal(tf_t.numpy(), tf_r.numpy())


def test_x_tile_interval_matches_jax():
    rng = np.random.default_rng(5)
    n, tiles_x = 4000, 12
    sc = _scene(6, n, tiles_x * TILE, 9 * TILE)
    mx, my = sc["mean2d"][:, 0], sc["mean2d"][:, 1]
    ca, cb, cc = sc["conic"].T
    tau = np.log(np.maximum(sc["opacity"], 1e-12) * np.float32(255.0)).astype(np.float32)
    ty = rng.integers(0, 9, n).astype(np.int32)
    min_x = rng.integers(0, 6, n).astype(np.int32)
    max_x = (min_x + rng.integers(0, 7, n)).astype(np.int32)
    args = [mx, my, ca, cb, cc, tau, ty, min_x, max_x]
    want = jtiled._x_tile_interval(*[jnp.asarray(a) for a in args], tiles_x)
    got = tiled.x_tile_interval(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args], tiles_x)
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))
    assert (got[1] > got[0]).any() and (got[1] <= got[0]).any()


def test_depth_order_within_tiles():
    """Each tile's list is in (depth, index) order, culled Gaussians absent."""
    w, h = 64, 48
    sc = _scene(7, 300, w, h)
    sc["depth"][:50] = sc["depth"][50:100]  # ties break by index
    t = _torch(sc)
    bins = tiled.bin_gaussians(t["mean2d"], t["conic"], t["opacity"], t["depth"], t["radius"],
                               t["valid"], w, h)
    pl = bins["point_list"].numpy()
    ok = sc["valid"] & (sc["radius"] > 0)
    assert ok[pl].all()
    for s, e in zip(bins["tile_start"].numpy(), bins["tile_end"].numpy()):
        ids = pl[s:e]
        key = list(zip(sc["depth"][ids], ids))
        assert key == sorted(key)


def test_wrapper_checks_inputs():
    w, h = 32, 32
    sc = _torch(_scene(8, 50, w, h))
    bins = tiled.bin_gaussians(sc["mean2d"], sc["conic"], sc["opacity"], sc["depth"],
                               sc["radius"], sc["valid"], w, h)
    good = tiled.kernel_args(bins, sc["mean2d"], sc["conic"], sc["opacity"], sc["rgb"], w, h)
    for i, bad in ((4, good[4].double()), (4, good[4][:, :9].contiguous()), (3, good[3].long())):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            flat_raster.rasterize_tiles(*args)
