"""Port parity of the raster backward: the gradients of `RasterizeFunction`
(binning, Kernel A's and Kernel C's plain versions) against `jax.grad`
through the JAX tiled rasterizer with the Pallas backend and tight culling,
which on the CPU runs `backward_flat` in interpret mode.

Tolerance: rtol 1e-4 per element, plus an atol of 2e-6 of the field's
largest gradient. Kernel C recovers each transmittance by division
(T_i = T / (1 - alpha)) where the Pallas kernel divides t_final by a
reverse cumulative product, and the two sum the per-pixel terms in other
orders; under a random +-1 cotangent, elements that are sums of many
cancelling terms then differ by up to 1e-6 of the field's scale."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.render.tiled import instance_count_tight, rasterize_tiled, row_count
from sgs_tpu_torch.core.projection import TILE
from sgs_tpu_torch.ops import flat_raster
from sgs_tpu_torch.render import tiled
from test_torch_raster import _scene, _torch

torch.set_num_threads(1)
RTOL, ATOL_SCALE = 1e-4, 2e-6
FIELDS = ("mean2d", "conic", "rgb", "opacity", "bg")


def _cotangent(seed, w, h):
    return np.random.default_rng(seed).standard_normal((3, h, w)).astype(np.float32)


def _jax_grads(sc, ct, w, h):
    j = {k: jnp.asarray(v) for k, v in sc.items()}
    rc = int(row_count(j["mean2d"], j["radius"], j["valid"], w, h)) + 16
    ti = int(instance_count_tight(
        j["mean2d"], j["conic"], j["opacity"], j["depth"], j["radius"], j["valid"], w, h, rc
    ))

    def loss(m2, cn, rg, op, bg):
        img, _ = rasterize_tiled(
            m2, j["depth"], cn, rg, op, j["radius"], j["valid"], bg, w, h,
            max_instances=-(-ti // 256) * 256 + 256, backend="pallas", max_row_instances=rc,
        )
        return jnp.sum(img * ct)

    grads = jax.grad(loss, argnums=tuple(range(5)))(*(j[k] for k in FIELDS))
    return [np.asarray(g) for g in grads]


def _port_grads(sc, ct, w, h):
    t = _torch(sc)
    leaves = [t[k].clone().requires_grad_(True) for k in FIELDS]
    m2, cn, rg, op, bg = leaves
    img, aux = tiled.rasterize_tiled(m2, t["depth"], cn, rg, op, t["radius"], t["valid"], bg, w, h)
    (img * torch.from_numpy(ct)).sum().backward()
    return [x.grad.numpy() for x in leaves], aux


@pytest.mark.parametrize("w,h,seed", [(64, 48, 0), (70, 33, 1)])
def test_raster_gradients_match_jax_pallas(w, h, seed):
    sc = _scene(seed, 300, w, h)
    ct = _cotangent(seed + 10, w, h)
    got, aux = _port_grads(sc, ct, w, h)
    bins = aux["bins"]
    counts = (bins["tile_end"] - bins["tile_start"]).numpy()
    assert (counts == 0).any(), "scene should hold an empty tile"
    assert float(aux["t_final"][TILE + 8, TILE + 8]) < 1e-2, "stacked tile should saturate"
    want = _jax_grads(sc, ct, w, h)
    for name, g, wv in zip(FIELDS, got, want):
        assert g.shape == wv.shape, name
        assert np.abs(wv).max() > 0, name
        np.testing.assert_allclose(g, wv, rtol=RTOL, atol=ATOL_SCALE * np.abs(wv).max(),
                                   err_msg=f"grad {name}")


def test_raster_backward_is_bitwise_repeatable():
    w, h = 70, 33
    sc = _scene(4, 300, w, h)
    ct = _cotangent(5, w, h)
    first, _ = _port_grads(sc, ct, w, h)
    again, _ = _port_grads(sc, ct, w, h)
    for name, a, b in zip(FIELDS, first, again):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_culled_and_unreached_gaussians_get_zero():
    """Invalid Gaussians and those no pixel composited carry zero
    gradients; d_bg is sum(t_final * dC)."""
    w, h = 64, 48
    sc = _scene(6, 300, w, h)
    ct = _cotangent(7, w, h)
    (g_m, g_c, g_r, g_o, g_bg), aux = _port_grads(sc, ct, w, h)
    dead = ~sc["valid"]
    assert dead.any()
    for g in (g_m, g_c, g_r, g_o):
        assert not g[dead].any()
    want_bg = (aux["t_final"].numpy()[None] * ct).sum(axis=(1, 2))
    np.testing.assert_allclose(g_bg, want_bg, rtol=1e-5)


def test_backward_wrapper_checks_inputs():
    w, h = 32, 32
    sc = _torch(_scene(8, 50, w, h))
    bins = tiled.bin_gaussians(sc["mean2d"], sc["conic"], sc["opacity"], sc["depth"],
                               sc["radius"], sc["valid"], w, h)
    args = tiled.kernel_args(bins, sc["mean2d"], sc["conic"], sc["opacity"], sc["rgb"], w, h)
    _, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    dc = torch.zeros((3, h, w))
    good = (*args, t_final, n_contrib, dc, torch.zeros(3), bins["perm"], bins["rank_start"],
            bins["order"])
    assert flat_raster.rasterize_tiles_backward(*good).shape == (50, 9)
    with pytest.raises(ValueError):
        flat_raster.rasterize_tiles_backward(*good[:9], dc.double(), *good[10:])
    with pytest.raises(ValueError):
        flat_raster.rasterize_tiles_backward(*good[:11], bins["perm"].int(), *good[12:])


def test_reduce_runs_plain_long_and_short_runs():
    """Runs of length 0, 1, 31, 32, 33 and 1000 and more, scattered through
    `order`: each Gaussian's sum against a float64 sum to 1e-6 relative
    (positive terms, so the relative bar is the f32 summation error of
    32 lane sums of at most 40 terms), empty runs exactly +0, and the
    result the same bits on a second call."""
    lengths = np.array([0, 1, 31, 32, 33, 1000, 1283, 0, 2, 64, 65, 1])
    rng = np.random.default_rng(11)
    inst = rng.uniform(0.0, 1.0, (int(lengths.sum()), 9)).astype(np.float32)
    rank_start = np.concatenate([[0], np.cumsum(lengths)])
    order = rng.permutation(lengths.shape[0])
    args = (torch.from_numpy(inst), torch.from_numpy(rank_start), torch.from_numpy(order))
    got = flat_raster.reduce_runs_plain(*args).numpy()
    again = flat_raster.reduce_runs_plain(*args).numpy()
    np.testing.assert_array_equal(got, again)
    for j, (b, e) in enumerate(zip(rank_start[:-1], rank_start[1:])):
        want = inst[b:e].astype(np.float64).sum(axis=0)
        row = got[order[j]]
        if e == b:
            assert (row == 0).all() and not np.signbit(row).any()
        else:
            np.testing.assert_allclose(row, want, rtol=1e-6, err_msg=f"run of {e - b}")


def test_reduce_runs_plain_order_is_lanes_then_butterfly():
    """A run of 70: lane l sums elements l, l + 32, l + 64 in turn, then
    the 32 lane sums meet in the xor-butterfly order (the kernel's warp
    per run); written out with numpy float32, the same bits."""
    rng = np.random.default_rng(12)
    x = rng.standard_normal((70, 9)).astype(np.float32)
    lanes = np.zeros((32, 9), np.float32)
    for i in range(70):
        lanes[i % 32] = lanes[i % 32] + x[i]
    for off in (16, 8, 4, 2, 1):
        lanes = lanes[:off] + lanes[off:2 * off]
    got = flat_raster.reduce_runs_plain(torch.from_numpy(x), torch.tensor([0, 70]),
                                        torch.tensor([0]))
    np.testing.assert_array_equal(got.numpy()[0], lanes[0])


def test_tile_schedule_is_longest_first_and_does_not_change_outputs():
    """Binning's schedule is the tiles by list length, longest first
    (stable), a permutation; Kernel A's and C's plain versions give the
    same bits under it, raster order, the reverse and a random order."""
    w, h = 70, 33
    sc = _torch(_scene(9, 300, w, h))
    bins = tiled.bin_gaussians(sc["mean2d"], sc["conic"], sc["opacity"], sc["depth"],
                               sc["radius"], sc["valid"], w, h)
    schedule = bins["schedule"]
    counts = (bins["tile_end"] - bins["tile_start"]).numpy()
    n_tiles = counts.shape[0]
    assert schedule.dtype == torch.int32
    assert sorted(schedule.tolist()) == list(range(n_tiles))
    np.testing.assert_array_equal(schedule.numpy(), np.argsort(-counts, kind="stable"))
    args = tiled.kernel_args(bins, sc["mean2d"], sc["conic"], sc["opacity"], sc["rgb"], w, h)
    fwd = flat_raster.rasterize_tiles_plain(*args)
    dc = torch.from_numpy(_cotangent(10, w, h))
    extra = (fwd[1], fwd[2], dc, torch.tensor([0.2, 0.5, 0.9]), bins["perm"], bins["rank_start"],
             bins["order"])
    bwd = flat_raster.rasterize_tiles_backward_plain(*args, *extra)
    rng = np.random.default_rng(3)
    for other in (np.arange(n_tiles), np.arange(n_tiles)[::-1].copy(), rng.permutation(n_tiles)):
        alt = list(args)
        alt[3] = torch.from_numpy(other.astype(np.int32))
        for a, b in zip(fwd, flat_raster.rasterize_tiles_plain(*alt)):
            assert torch.equal(a, b)
        assert torch.equal(bwd, flat_raster.rasterize_tiles_backward_plain(*alt, *extra))


def test_walk_ablation_variants_apply():
    """Each variant of `sgs_tpu_torch.tools.walk_ablation` finds the text it
    undoes in the committed Kernel C source and changes it."""
    from sgs_tpu_torch.tools import walk_ablation

    committed = walk_ablation.SOURCE.read_text()
    for name in walk_ablation.VARIANTS:
        text = walk_ablation.variant_source(name).read_text()
        assert text != committed and "flat_raster_backward_kernel" in text, name
