"""Port parity: Kernel B's plain version, PSNR and L1 (sgs_tpu_torch.ops.ssim)
against the JAX jnp oracle `_ssim_jnp` and the fused Pallas forward
`ssim_kernels.ssim_forward` in interpret mode. SSIM at rtol 1e-5, atol
1e-6: the bar of tests/test_ssim_fused.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgs_tpu.ops import ssim as jssim
from sgs_tpu.ops.pallas import ssim_kernels as sk
from sgs_tpu_torch.ops import ssim

torch.set_num_threads(1)
SIZES = [(37, 53), (64, 128), (100, 240), (16, 16), (48, 96)]


def _pair(seed, h, w):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.15, x.shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("h,w", SIZES)
def test_plain_matches_ssim_jnp(h, w):
    x, y = _pair(0, h, w)
    want = float(jssim._ssim_jnp(jnp.asarray(x), jnp.asarray(y), 11))
    got = float(ssim.ssim_plain(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("h,w", SIZES)
def test_plain_matches_fused_pallas(h, w):
    x, y = _pair(1, h, w)
    want = float(sk.ssim_forward(jnp.asarray(x), jnp.asarray(y), interpret=True)[0])
    got = float(ssim.ssim(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_identical_images_give_one():
    x, _ = _pair(2, 40, 72)
    got = float(ssim.ssim(torch.from_numpy(x), torch.from_numpy(x)))
    np.testing.assert_allclose(got, 1.0, atol=1e-6)


def test_window_matches_jax():
    np.testing.assert_allclose(
        ssim.gaussian_window().numpy(), np.asarray(jssim._gaussian_window(11, 1.5)),
        rtol=1e-6, atol=0,
    )


@pytest.mark.parametrize("h,w", [(37, 53), (100, 240)])
def test_psnr_and_l1_match_jax(h, w):
    x, y = _pair(3, h, w)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    np.testing.assert_allclose(
        float(ssim.psnr(xt, yt)), float(jssim.psnr(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(ssim.l1_loss(xt, yt)), float(jssim.l1_loss(jnp.asarray(x), jnp.asarray(y))), rtol=1e-5
    )


def test_psnr_batched_matches_jax():
    """(B, C, H, W) gives one PSNR per image, (B, 1), as JAX's `psnr`;
    rtol 1e-5 as above. The (C, H, W) case stays a scalar."""
    pairs = [_pair(5 + b, 24, 40) for b in range(3)]
    x = np.stack([p[0] for p in pairs])
    y = np.stack([p[1] for p in pairs])
    want = np.asarray(jssim.psnr(jnp.asarray(x), jnp.asarray(y)))
    got = ssim.psnr(torch.from_numpy(x), torch.from_numpy(y))
    assert want.shape == tuple(got.shape) == (3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    for b in range(3):
        np.testing.assert_allclose(float(got[b, 0]), float(ssim.psnr(torch.from_numpy(x[b]),
                                                                     torch.from_numpy(y[b]))),
                                   rtol=1e-6)
    assert ssim.psnr(torch.from_numpy(x[0]), torch.from_numpy(y[0])).shape == ()


def test_kernel_wrapper_refuses_cpu_tensors():
    x, y = _pair(4, 16, 16)
    with pytest.raises(ValueError):
        ssim.ssim_forward(torch.from_numpy(x), torch.from_numpy(y))
