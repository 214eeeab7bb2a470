"""Kernels A-K on the card against their plain PyTorch versions, and the
native JPEG decoder (host C++ built with nvcc) against PIL's digests of the
committed cases and the plain decoder.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU with nvcc
and skip without one. On the card (no JAX there, so no conftest):

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from sgs_tpu_torch.core.projection import tile_rect
from sgs_tpu_torch.ops import flat_raster, ssim
from sgs_tpu_torch.render import tiled

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are CUDA C++ with no CPU mode")
    return torch.device("cuda")


def _scene(seed, n, w, h, dev):
    rng = np.random.default_rng(seed)
    l1 = rng.uniform(0.005, 0.5, n)
    l2 = rng.uniform(0.005, 0.5, n)
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return dict(
        mean2d=f(rng.uniform(-8, [w + 8, h + 8], (n, 2))),
        depth=f(rng.uniform(0.5, 10.0, n)),
        conic=f(np.stack([l1 * c * c + l2 * s * s, (l1 - l2) * s * c, l1 * s * s + l2 * c * c], 1)),
        rgb=f(rng.uniform(0, 1, (n, 3))),
        opacity=f(rng.uniform(0.001, 0.99, n)),
        radius=torch.as_tensor(np.ceil(3.0 / np.sqrt(np.minimum(l1, l2))).astype(np.int32), device=dev),
        valid=torch.as_tensor(rng.uniform(size=n) > 0.1, device=dev),
    )


@pytest.mark.parametrize("w,h", [(64, 48), (250, 190)])
def test_raster_kernel_matches_plain(dev, w, h):
    sc = _scene(0, 2000, w, h, dev)
    bins = tiled.bin_gaussians(sc["mean2d"], sc["conic"], sc["opacity"], sc["depth"],
                               sc["radius"], sc["valid"], w, h)
    args = tiled.kernel_args(bins, sc["mean2d"], sc["conic"], sc["opacity"], sc["rgb"], w, h)
    before = flat_raster.KERNEL.launches
    got = flat_raster.rasterize_tiles(*args)
    assert flat_raster.KERNEL.launches == before + 1
    want = flat_raster.rasterize_tiles_plain(*args)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv), "Kernel A differs from its plain version"


@pytest.mark.parametrize("w,h", [(64, 48), (250, 190)])
def test_rect_binning_equals_tight_on_the_card(dev, w, h):
    """--no-tight_culling: Kernel A on the rect bins composites the tight
    bins' image, bit for bit, from more instances."""
    sc = _scene(1, 2000, w, h, dev)
    out = {}
    for tight in (True, False):
        bins = tiled.bin_gaussians(sc["mean2d"], sc["conic"], sc["opacity"], sc["depth"],
                                   sc["radius"], sc["valid"], w, h, tight)
        args = tiled.kernel_args(bins, sc["mean2d"], sc["conic"], sc["opacity"], sc["rgb"], w, h)
        color, t_final, _ = flat_raster.rasterize_tiles(*args)
        out[tight] = (color, t_final, bins["point_list"].shape[0])
    assert out[True][2] < out[False][2]
    assert torch.equal(out[True][0], out[False][0]) and torch.equal(out[True][1], out[False][1])


SSIM_SIZES = [(7, 9), (37, 53), (64, 128), (100, 244), (800, 800), (1080, 1920)]


@pytest.mark.parametrize("h,w", SSIM_SIZES)
def test_ssim_kernel_matches_plain(dev, h, w):
    rng = np.random.default_rng(h)
    x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.15, x.shape), 0, 1).astype(np.float32)
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    before = ssim.KERNEL.launches
    got = float(ssim.ssim_forward(xt, yt))
    assert ssim.KERNEL.launches == before + 1
    assert got == float(ssim.ssim_forward(xt, yt)), "not bitwise repeatable"
    assert got == float(ssim.ssim_plain(xt, yt)), "Kernel B differs from its plain version"


def _raster_case(dev, w, h, seed):
    """The random scene plus a stack of opaque splats that saturates tile
    (2, 2), with tile 0 kept empty; binned, composited by Kernel A."""
    sc = _scene(seed, 2000, w, h, dev)
    n_stack = 48
    sc["mean2d"][:n_stack] = torch.tensor([40.0, 40.0], device=dev) + torch.rand(
        (n_stack, 2), generator=torch.Generator(device=dev).manual_seed(seed), device=dev) * 4 - 2
    sc["conic"][:n_stack] = torch.tensor([0.03, 0.0, 0.03], device=dev)
    sc["opacity"][:n_stack] = 0.95
    sc["radius"][:n_stack] = 18
    sc["valid"][:n_stack] = True
    min_x, _, min_y, _ = tile_rect(sc["mean2d"], sc["radius"].float(), -(-w // 16), -(-h // 16))
    sc["valid"] &= ~((min_x == 0) & (min_y == 0))
    bins = tiled.bin_gaussians(sc["mean2d"], sc["conic"], sc["opacity"], sc["depth"],
                               sc["radius"], sc["valid"], w, h)
    args = tiled.kernel_args(bins, sc["mean2d"], sc["conic"], sc["opacity"], sc["rgb"], w, h)
    _, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    dc = torch.randn((3, h, w), generator=g, device=dev)
    bg = torch.rand(3, generator=g, device=dev)
    counts = bins["tile_end"] - bins["tile_start"]
    assert int(counts[0]) == 0, "tile 0 should be empty"
    assert float(t_final[40, 40]) < 1e-2, "the stacked tile should saturate"
    return (*args, t_final, n_contrib, dc, bg, bins["perm"], bins["rank_start"], bins["order"])


@pytest.mark.parametrize("w,h", [(64, 48), (250, 190)])
def test_raster_backward_kernel_matches_plain(dev, w, h):
    args = _raster_case(dev, w, h, 1)
    before = flat_raster.BACKWARD.launches
    got = flat_raster.rasterize_tiles_backward(*args)
    assert flat_raster.BACKWARD.launches == before + 1
    again = flat_raster.rasterize_tiles_backward(*args)
    assert torch.equal(got, again), "Kernel C is not bitwise repeatable"
    want = flat_raster.rasterize_tiles_backward_plain(*args)
    assert torch.equal(got, want), "Kernel C differs from its plain version"


def test_reduce_kernel_matches_plain(dev):
    """Kernel C's reduction on runs of length 0 to 2,000, bit for bit."""
    rng = np.random.default_rng(3)
    lengths = np.concatenate([[0, 1, 2, 31, 32, 33, 1000, 2000], rng.integers(0, 6, 3000)])
    inst = torch.as_tensor(rng.standard_normal((int(lengths.sum()), 9)).astype(np.float32), device=dev)
    rank_start = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)]), device=dev)
    order = torch.as_tensor(rng.permutation(lengths.shape[0]), device=dev)
    got = flat_raster.reduce_runs(inst, rank_start, order)
    assert torch.equal(got, flat_raster.reduce_runs_plain(inst, rank_start, order))


@pytest.mark.parametrize("h,w", SSIM_SIZES)
def test_ssim_backward_kernel_matches_plain(dev, h, w):
    rng = np.random.default_rng(h + 1)
    x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.15, x.shape), 0, 1).astype(np.float32)
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    cot = torch.tensor(0.7, device=dev)
    before = ssim.BACKWARD.launches
    got = ssim.ssim_backward(xt, yt, cot)
    assert ssim.BACKWARD.launches == before + 1
    want = ssim.ssim_backward_plain(xt, yt, cot)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv), "Kernel D differs from its plain version"
    again = ssim.ssim_backward(xt, yt, cot)
    assert all(torch.equal(g, a) for g, a in zip(got, again)), "not bitwise repeatable"
    dx, dy = ssim.ssim_backward(xt, yt, cot, with_dy=False)
    assert dy is None and torch.equal(dx, want[0])


def test_wrappers_refuse_bad_inputs(dev):
    x = torch.zeros((3, 16, 16), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        ssim.ssim_forward(x, x)
    with pytest.raises(ValueError):
        ssim.ssim_forward(x.float().transpose(1, 2), x.float())



def _exp_scene(dev):
    """The experiments' scene, small: 3,000 Gaussians at 128x96 (empty
    corner tiles, saturated centre tiles), packed into rows of 64."""
    from sgs_tpu_torch.tools import exp_scene

    sc = exp_scene.build_scene(128, 96, 3000, 0, dev)
    assert int((sc["n_chunks"] == 0).sum()) > 0, "the scene should have an empty tile"
    return sc


def _edge_scene(dev):
    """Tiles of 1 row back to back, of 33 and 40 rows (past the deepest
    ring), an empty tile, a tile saturated in the middle of its first row
    and one whose top half saturates while its bottom half walks on (warps
    with no live pixel), 300 tiles in all (more than one per block)."""
    from sgs_tpu_torch.tools import exp_scene

    return exp_scene.edge_scene(dev)


@pytest.mark.parametrize("scene", ["random", "edges"])
@pytest.mark.parametrize("krows", [8, 32])
@pytest.mark.parametrize("kernel,mode", [("E", "hs"), ("E", "nocp"), ("E", "mxu"),
                                         ("G", "hs"), ("G", "mxu")])
def test_exp_forward_kernels_match_plain(dev, kernel, mode, krows, scene):
    from sgs_tpu_torch.ops import exp_forward as ef

    sc = _exp_scene(dev) if scene == "random" else _edge_scene(dev)
    crs, nch, sched, tx = sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"]
    if kernel == "E":
        count, run = ef.E, lambda: ef.forward_rows(sc["packed_fm"], crs, nch, sched, tx, mode, krows)
        want = ef.forward_rows_plain(sc["packed_fm"], crs, nch, sched, tx, mode)
    else:
        count, run = ef.G, lambda: ef.transposed_rows(sc["packed"], crs, nch, sched, tx, mode, krows)
        want = ef.transposed_rows_plain(sc["packed"], crs, nch, sched, tx, mode)
    before = count.launches
    got = run()
    assert count.launches == before + 1
    assert torch.equal(got, run()), "not bitwise repeatable"
    if mode != "nocp":
        t_final = want[:, 4, :] if kernel == "G" else want[:, :, 4]
        assert float(t_final.min()) < 1e-3, "some pixel should saturate"
    if scene == "edges" and mode != "nocp":
        state = want.transpose(1, 2) if kernel == "G" else want
        dead = ef.dead_warps(state, sc["row_first"], sc["row_tile"], sc["num_tiles"])
        assert dead["dead_warps"] > 0, "some walked warp should hold no live pixel"
    if mode != "mxu":
        assert torch.equal(got, want), f"Kernel {kernel} {mode} differs from its plain version"
        return
    if kernel == "G":
        got, want = got.transpose(1, 2), want.transpose(1, 2)
    near = ef.near_cut(sc["packed_fm"], crs, nch, tx)
    err = ef.rows_error(got, want, sc["row_tile"], near)
    assert err["finite"] and err["values"] <= ef.MXU_ATOL and err["last_contrib_flips"] == 0, err


@pytest.mark.parametrize("scene", ["random", "edges"])
@pytest.mark.parametrize("krows,out_cols", [(8, 8), (8, 1), (32, 1)])
@pytest.mark.parametrize("mode", ["empty", "outonly", "alpha"])
def test_exp_ablation_kernel_matches_plain(dev, mode, krows, out_cols, scene):
    from sgs_tpu_torch.ops import exp_forward as ef

    sc = _exp_scene(dev) if scene == "random" else _edge_scene(dev)
    args = (sc["packed_fm"], sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"])
    before = ef.F.launches
    got = ef.ablation_rows(*args, mode, krows, out_cols)
    assert ef.F.launches == before + 1
    want = ef.ablation_rows_plain(*args, mode, out_cols)
    if mode == "empty":
        got, want = got[:1], want[:1]
    assert torch.equal(got, want), f"Kernel F {mode} differs from its plain version"
    assert torch.equal(ef.exp_ablation(*args, mode, krows, out_cols), want[0])


@pytest.mark.parametrize("rows", [32, 37, 1100])
def test_gather_kernels_match_plain(dev, rows):
    """H, I and J bit for bit and repeatable, at the CPU tests' size, at 37
    rows (not a whole number of 8-row steps) and at 1,100 (J over 9
    blocks, the last ragged); some windows start at m."""
    from sgs_tpu_torch.ops import gather as g
    from sgs_tpu_torch.tools import gather_inputs as gi

    table, ids = gi.vmem_inputs(1000, rows, seed=rows, device=dev)
    m = 50 * rows
    attr, starts = gi.dma_inputs(m, rows, seed=rows, device=dev)
    assert int(starts[: rows // 8 * 8].max()) == m
    packed = gi.pack(attr, starts, m)
    cases = [(g.H, lambda: g.vmem_gather_steps(table, ids), g.vmem_gather_steps_plain(table, ids)),
             (g.I, lambda: g.packed_sum_steps(packed), g.packed_sum_steps_plain(packed)),
             (g.J, lambda: g.dma_gather(attr, starts), g.dma_gather_plain(attr, starts))]
    for count, run, want in cases:
        before = count.launches
        got = run()
        assert count.launches == before + 1
        assert torch.equal(got, run()), f"Kernel {count.name} is not bitwise repeatable"
        assert torch.equal(got, want), f"Kernel {count.name} differs from its plain version"


@pytest.mark.parametrize("rows,rec", [(16384, 16), (16388, 8), (1001, 16), (1002, 8)])
def test_identity_kernel_matches_plain(dev, rows, rec):
    """K from a row-major and a field-major source, also with a last tile
    of 4 rows (16,388) and rows not a multiple of 4 (the field-major
    copy's scalar path)."""
    from sgs_tpu_torch.ops import gather as g

    x = torch.as_tensor(np.random.default_rng(rows).normal(size=(rows, rec)).astype(np.float32), device=dev)
    for src in (x, g.field_major(x)):
        before = g.K.launches
        got = g.layout_identity(src)
        assert g.K.launches == before + 1
        assert got.is_contiguous() and torch.equal(got, g.layout_identity(src))
        assert torch.equal(got, x)


def test_alpha_skip_takes_some_records(dev):
    """The random scene exercises both sides of F alpha's exp skip (the
    ablation test above holds the kernel to its plain version on it)."""
    from sgs_tpu_torch.ops import exp_forward as ef

    sc = _exp_scene(dev)
    far = ef.far_records(sc["packed_fm"], sc["row_tile"], sc["tiles_x"], sc["num_tiles"])
    assert 0 < far["far"] < far["slot_warps"], far


def test_l2_read_rate_is_a_rate(dev):
    """The L2 probe reads what it says: more passes take longer, and the
    rate lies between the HBM's 3.35 TB/s and 100 TB/s."""
    from sgs_tpu_torch.tools import l2_rate

    one = l2_rate.l2_read_rate(dev, mib=24, passes=5)
    more = l2_rate.l2_read_rate(dev, mib=24, passes=20)
    assert more["ms"] > one["ms"]
    assert 3.35e12 < more["bytes_per_s"] < 1e14, more


JPEG_CASES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "jpeg_cases")
JPEG_DIGESTS = json.load(open(os.path.join(JPEG_CASES, "digests.json")))


@pytest.mark.parametrize("name", sorted(JPEG_DIGESTS))
def test_native_jpeg_equals_digest_and_plain(dev, name):
    from sgs_tpu_torch.data import jpeg
    from sgs_tpu_torch.ops.jpeg import read_jpeg_native

    path = os.path.join(JPEG_CASES, name)
    got = read_jpeg_native(path)
    assert hashlib.sha256(got.tobytes()).hexdigest() == JPEG_DIGESTS[name]["sha256"]
    assert list(got.shape) == JPEG_DIGESTS[name]["shape"]
    if got.shape[0] * got.shape[1] < 64_000:
        np.testing.assert_array_equal(got, jpeg.read_jpeg(path))


@pytest.mark.parametrize("layout", ["equal", "balanced"])
def test_band_stitch_matches_full_frame(dev, layout):
    """The band path on one card (chip_smoke phase 14 (a) at a small size):
    a seeded 3,000-Gaussian scene at 200x150, its 4 row bands composited
    by Kernel A (once a band) and differentiated by Kernel C (once a band),
    stitched; the image within 3e-5 of the full frame's Kernel A render,
    the parameter and tap gradients within rtol 2e-3, atol 3e-6 of the
    full frame's Kernel C step (JAX's band bars)."""
    import math

    from sgs_tpu_torch.core.camera import Camera
    from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, GaussianModel
    from sgs_tpu_torch.parallel import hybrid, tile_shard
    from sgs_tpu_torch.render.pipeline import project_and_shade, render

    rng = np.random.default_rng(4)
    n, w, h, n_bands = 3000, 200, 150, 4
    pts = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n) ** 3, rng.uniform(2.5, 6, n)], -1)
    model = GaussianModel.from_pcd(pts.astype(np.float32), rng.uniform(size=(n, 3)).astype(np.float32), 1,
                                   device=dev)
    model.scaling[:n] = torch.as_tensor(rng.uniform(-4.0, -2.0, (n, 3)), dtype=torch.float32, device=dev)
    model.opacity[:n] = torch.as_tensor(rng.uniform(-1.0, 3.0, (n, 1)), dtype=torch.float32, device=dev)
    fovx = math.radians(60)
    cam = Camera.from_Rt(np.eye(3), np.zeros(3), fovx, 2 * math.atan(math.tan(fovx / 2) * h / w), w, h,
                         device=dev)
    target = torch.as_tensor(rng.uniform(size=(3, h, w)), dtype=torch.float32, device=dev)
    bg = torch.tensor([0.2, 0.5, 0.7], device=dev)
    if layout == "equal":
        offsets, pad = hybrid.equal_band_offsets(h, n_bands)
    else:
        p = project_and_shade(cam, model.render_inputs(1))
        hist = tile_shard.row_load_histogram(p["mean2d"], p["radius"], p["valid"], w, h)
        offsets, pad = tile_shard.balanced_band_offsets(hist.cpu().numpy(), n_bands)
    out = {}
    for name in ("full", "bands"):
        leaves = {f: getattr(model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
        tap = torch.zeros((model.capacity, 3), device=dev, requires_grad=True)
        a0, c0 = flat_raster.KERNEL.launches, flat_raster.BACKWARD.launches
        if name == "full":
            img = render(cam, model.with_params(leaves).render_inputs(1), bg, vspace_tap=tap)["render"]
        else:
            rec, _, _ = tile_shard.splat_records(leaves, model.alive, cam, 1, tap)
            img, _ = hybrid.render_bands(rec, offsets, pad, w, h, bg, own=layout == "balanced")
        loss = torch.mean(torch.abs(img - target))
        grads = torch.autograd.grad(loss, [leaves[f] for f in PARAM_FIELDS] + [tap])
        torch.cuda.synchronize()
        k = 1 if name == "full" else n_bands
        assert (flat_raster.KERNEL.launches - a0, flat_raster.BACKWARD.launches - c0) == (k, k)
        out[name] = (img.detach(), grads)
    assert float((out["bands"][0] - out["full"][0]).abs().max()) <= 3e-5
    for f, g, want in zip(PARAM_FIELDS + ("tap",), out["bands"][1], out["full"][1]):
        if f == "tap":
            g, want = g[:, :2], want[:, :2]
        torch.testing.assert_close(g, want, rtol=2e-3, atol=3e-6, msg=f)


def test_bench_scale_on_card(dev):
    """`run_config` on the card at a small size: the counts of the
    binning, times and peak memory measured; `bench.measure`'s render-only
    image equal to its forward+backward image; A and C launched once a
    call of the benchmark loss."""
    from sgs_tpu_torch import bench
    from sgs_tpu_torch.tools import bench_scale

    r = bench_scale.run_config(20_000, True, 480, 270, device=dev, iters=1)
    model, cam = bench_scale.scale_scene(20_000, True, 480, 270, device=dev)
    counts = bench_scale.scene_counts(model, cam)
    assert {k: r[k] for k in counts} == counts and counts["instances"] > 20_000
    assert r["fwd_bwd_ms"] > 0 and r["render_ms"] > 0 and r["peak_gib"] > 0
    a0, c0 = flat_raster.KERNEL.launches, flat_raster.BACKWARD.launches
    m = bench.measure(model, cam, iters=2)
    assert (flat_raster.KERNEL.launches - a0, flat_raster.BACKWARD.launches - c0) == (6, 3)
    assert torch.equal(m["image"], m["render_image"]) and m["fps"] > 0 and m["render_fps"] > 0


def test_eval_ply_on_card(dev, capsys):
    """`tools/eval_ply.py` on the LGM snapshot prints the line that the JAX
    script prints on the CPU (`tests/test_torch_bench.py`)."""
    from sgs_tpu_torch.tools import eval_ply

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    eval_ply.main([os.path.join(root, "assets", "lgm", "point_cloud.ply"),
                   os.path.join(root, "data", "lgm400"), "0"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line == "test_psnr_mean 21.300 views 8 gaussians 16000 overflowed_views 0"
