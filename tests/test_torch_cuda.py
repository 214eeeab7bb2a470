"""Kernels A, B, C and D on the card against their plain PyTorch versions.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU with nvcc
and skip without one. On the card (no JAX there, so no conftest):

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda tests/test_torch_cuda.py
"""

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
    torch.testing.assert_close(got[0], want[0], atol=3e-5, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=3e-5, rtol=0)
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("h,w", [(37, 53), (64, 128), (800, 800)])
def test_ssim_kernel_matches_plain(dev, h, w):
    rng = np.random.default_rng(h)
    x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.15, x.shape), 0, 1).astype(np.float32)
    xt, yt = torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)
    got = float(ssim.ssim_forward(xt, yt))
    assert got == float(ssim.ssim_forward(xt, yt)), "not bitwise repeatable"
    np.testing.assert_allclose(got, float(ssim.ssim_plain(xt, yt)), rtol=1e-5, atol=1e-6)


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
    scale = want.abs().amax(dim=0, keepdim=True)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6 * float(scale.max()))


@pytest.mark.parametrize("h,w", [(37, 53), (64, 128), (800, 800)])
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
        torch.testing.assert_close(g, wv, rtol=1e-5, atol=1e-6 * float(wv.abs().max()))


def test_wrappers_refuse_bad_inputs(dev):
    x = torch.zeros((3, 16, 16), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        ssim.ssim_forward(x, x)
    with pytest.raises(ValueError):
        ssim.ssim_forward(x.float().transpose(1, 2), x.float())
