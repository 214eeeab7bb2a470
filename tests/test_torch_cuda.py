"""Kernels A and B on the card against their plain PyTorch versions.

CUDA kernels have no CPU mode, so these tests need an NVIDIA GPU with nvcc
and skip without one. On the card (no JAX there, so no conftest):

    python -m pytest --noconftest -p no:cacheprovider -o addopts="" -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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


def test_wrappers_refuse_bad_inputs(dev):
    x = torch.zeros((3, 16, 16), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        ssim.ssim_forward(x, x)
    with pytest.raises(ValueError):
        ssim.ssim_forward(x.float().transpose(1, 2), x.float())
