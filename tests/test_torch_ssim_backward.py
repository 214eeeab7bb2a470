"""Port parity of the SSIM backward: Kernel D's plain version
(sgs_tpu_torch.ops.ssim.ssim_backward_plain) against the fused Pallas
backward `ssim_kernels.ssim_backward` in interpret mode and against
autograd through the plain forward, and the `SSIMFunction` / training loss
against `jax.grad` of the JAX loss. Gradients to rtol 1e-4, atol 1e-6:
the bar of tests/test_ssim_fused.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.ops import ssim as jssim
from sgs_tpu.ops.pallas import ssim_kernels as sk
from sgs_tpu_torch.ops import ssim

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-6


def _pair(seed, h, w):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.15, x.shape), 0, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("h,w", [(37, 53), (64, 96)])
def test_plain_backward_matches_pallas_backward(h, w):
    x, y = _pair(1, h, w)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    _, p_h_t = sk.ssim_forward(jx, jy, interpret=True)
    want = sk.ssim_backward(jx, jy, p_h_t, jnp.float32(0.7), interpret=True)
    got = ssim.ssim_backward_plain(torch.from_numpy(x), torch.from_numpy(y), torch.tensor(0.7))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("h,w", [(37, 53), (64, 128), (16, 16)])
def test_plain_backward_matches_autograd(h, w):
    x, y = _pair(2, h, w)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    ssim.ssim_plain(xt, yt).backward()
    got = ssim.ssim_backward_plain(torch.from_numpy(x), torch.from_numpy(y), torch.tensor(1.0))
    np.testing.assert_allclose(got[0].numpy(), xt.grad.numpy(), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), yt.grad.numpy(), rtol=RTOL, atol=ATOL)


def test_training_loss_and_gradient_match_jax():
    x, y = _pair(3, 40, 72)
    lam = 0.2
    want, want_g = jax.value_and_grad(jssim.training_loss)(jnp.asarray(x), jnp.asarray(y), lam)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = ssim.training_loss(xt, torch.from_numpy(y), lam)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_g), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        float(ssim.l2_loss(torch.from_numpy(x), torch.from_numpy(y))),
        float(jssim.l2_loss(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6,
    )


def test_backward_wrapper_refuses_cpu_tensors():
    x = torch.zeros((3, 16, 16))
    with pytest.raises(ValueError):
        ssim.ssim_backward(x, x, torch.tensor(1.0))
