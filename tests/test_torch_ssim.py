"""Port parity: Kernel B's plain version, PSNR and L1 (sgs_tpu_torch.ops.ssim)
against the JAX jnp oracle `_ssim_jnp` and the fused Pallas forward
`ssim_kernels.ssim_forward` in interpret mode. SSIM at rtol 1e-5, atol
1e-6: the bar of tests/test_ssim_fused.py. The plain version's mean is
summed in Kernel B's order; that order is held to a float64 mean and to
the same order written out by hand."""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgs_tpu.ops import ssim as jssim
from sgs_tpu.ops.pallas import ssim_kernels as sk
from sgs_tpu_torch.ops import ssim

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
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
    """The 11 taps are JAX's f32 bits (Kernels B and D take the same)."""
    want = np.asarray(jssim._gaussian_window(11, 1.5), dtype=np.float32)
    got = ssim.gaussian_window().numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(np.asarray(ssim._window_arg(), dtype=np.float32).view(np.int32),
                                  want.view(np.int32))


def _jax_ssim_map(x, y):
    """`_ssim_jnp`'s map, before its mean, from the JAX package's own
    window and separable passes."""
    w1d = jssim._gaussian_window(11, 1.5)

    def conv(v):
        return jssim._separable_window_conv(v, w1d, 5)

    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = conv(x * x) - mu1_sq
    sigma2_sq = conv(y * y) - mu2_sq
    sigma12 = conv(x * y) - mu1_mu2
    c1, c2 = 0.01**2, 0.03**2
    return ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / ((mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2))


def test_map_matches_jax_on_committed_render():
    """A committed 400x400 render and its ground truth, decoded with the
    port's PNG codec: the port's SSIM map equals JAX's, run op by op, bit
    for bit (a natural image pair is ill-conditioned where random ones are
    not: 1-ulp taps moved its SSIM by about 8e-6), and the port's mean is
    within rtol 1e-6 of the map's float64 mean."""
    import jax

    from sgs_tpu_torch.metrics import read_image

    views = ROOT / "runs" / "lgm_r5" / "test" / "ours_3000"
    x = read_image(views / "renders" / "00000.png", torch.device("cpu"))
    y = read_image(views / "gt" / "00000.png", torch.device("cpu"))
    assert tuple(x.shape) == (3, 400, 400)
    with jax.disable_jit():
        want = np.asarray(_jax_ssim_map(jnp.asarray(x.numpy()), jnp.asarray(y.numpy())))
    got = ssim.ssim_map(x, y).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(float(ssim.ssim_plain(x, y)), want.astype(np.float64).mean(), rtol=1e-6)


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
