"""Port parity: Kernel B's plain version, PSNR and L1 (sgs_tpu_torch.ops.ssim)
against the JAX jnp oracle `_ssim_jnp` and the fused Pallas forward
`ssim_kernels.ssim_forward` in interpret mode. SSIM at rtol 1e-5, atol
1e-6: the bar of tests/test_ssim_fused.py. The plain version's mean is
summed in Kernel B's order; that order is held to a float64 mean and to
the same order written out by hand."""

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


@pytest.mark.parametrize("h,w", [(7, 9), (37, 53), (300, 330)])
def test_ordered_mean_matches_float64(h, w):
    """Kernel B's sum order against a float64 mean, rtol 1e-6 (f32 sums of
    at most a few hundred terms per level)."""
    rng = np.random.default_rng(h)
    m = rng.uniform(-0.2, 1.0, (3, h, w)).astype(np.float32)
    got = float(ssim.ordered_mean(torch.from_numpy(m)))
    np.testing.assert_allclose(got, m.astype(np.float64).mean(), rtol=1e-6)


def _butterfly_np(v):
    v = list(v)
    for off in (16, 8, 4, 2, 1):
        v = [np.float32(v[i] + v[i + off]) for i in range(off)]
    return v[0]


def _block_sum_np(vals):
    total = np.float32(0.0)
    for wp in range(ssim.WARPS):
        total = np.float32(total + _butterfly_np(vals[32 * wp:32 * wp + 32]))
    return total


def test_ordered_mean_order_by_hand():
    """The order written out in numpy f32, thread by thread, equals
    `ordered_mean` exactly; 330 tiles make the last block take two
    partials per thread for some threads."""
    rng = np.random.default_rng(7)
    c, h, w = 3, 300, 330
    m = rng.uniform(-0.2, 1.0, (c, h, w)).astype(np.float32)
    th, tw, strip = ssim.TILE_H, ssim.TILE_W, ssim.TILE_H // ssim.WARPS
    partials = []
    for ch in range(c):
        for ty in range(-(-h // th)):
            for tx in range(-(-w // tw)):
                vals = []
                for thread in range(ssim.THREADS):
                    col, r0 = tx * tw + thread % 32, ty * th + (thread // 32) * strip
                    s = np.float32(0.0)
                    for row in range(r0, r0 + strip):
                        s = np.float32(s + (m[ch, row, col] if row < h and col < w else np.float32(0)))
                    vals.append(s)
                partials.append(_block_sum_np(vals))
    lanes = []
    for thread in range(ssim.THREADS):
        s = np.float32(0.0)
        for i in range(thread, len(partials), ssim.THREADS):
            s = np.float32(s + partials[i])
        lanes.append(s)
    want = np.float32(_block_sum_np(lanes) / np.float32(c * h * w))
    assert float(ssim.ordered_mean(torch.from_numpy(m))) == float(want)
