"""Autograd parity of the port's core (SH, transforms, projection) with
`jax.grad` of the JAX functions on the same seeded inputs: a weighted sum
of the projection's mean2d and conic and of the clamped SH colour,
differentiated with respect to means, activated scales, quaternions and SH
coefficients. Gradients to rtol 1e-4 (the parity bar of README "Numerical
parity") plus an atol of 1e-6 of each gradient's largest magnitude.

JAX runs op by op (`jax.disable_jit`): under jit XLA contracts
multiply-adds in the projection (see tests/test_torch_slice.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.core import projection as jproj
from sgs_tpu.core import sh as jsh
from sgs_tpu.core import transforms as jtr
from sgs_tpu.core.camera import Camera as JaxCamera
from sgs_tpu_torch.core import projection, sh, transforms
from sgs_tpu_torch.core.camera import Camera

torch.set_num_threads(1)
N, W, H = 300, 64, 48


def _inputs(seed):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1.5, 1.5, (N, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(-4, -1, (N, 3))).astype(np.float32)
    quats = rng.normal(size=(N, 4)).astype(np.float32)
    shs = rng.normal(0, 0.4, (N, 16, 3)).astype(np.float32)
    shs[:40] = 0.0
    shs[:40, 0] = -3.0  # clamped colours: zero gradient through the clamp
    w = [rng.normal(size=s).astype(np.float32) for s in ((N, 2), (N, 3), (N, 3))]
    return (means, scales, quats, shs), w


def _camera_args():
    theta = 0.3
    c, s = np.cos(theta), np.sin(theta)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)
    T = np.array([0.1, -0.2, 4.0])
    return R, T, 0.9, 0.7


def _jax_loss(camera, weights, means, scales, quats, shs):
    cov = jtr.build_covariance(scales, jtr.normalize(quats, eps=1e-12))
    p = jproj.project_gaussians(means, cov, camera.world_view_transform, camera.full_proj_transform,
                                camera.tanfovx, camera.tanfovy, W, H)
    dirs = means - camera.camera_center[None, :]
    dirs = dirs / jnp.maximum(jnp.linalg.norm(dirs, axis=-1, keepdims=True), 1e-12)
    rgb = jsh.sh_to_rgb_clamped(3, shs, dirs)
    valid = (p["radius"] > 0)[:, None]
    return (jnp.sum(jnp.where(valid, p["mean2d"] * weights[0], 0.0))
            + jnp.sum(jnp.where(valid, p["conic"] * weights[1], 0.0)) + jnp.sum(rgb * weights[2]))


def _port_loss(camera, weights, means, scales, quats, shs):
    cov = transforms.build_covariance(scales, transforms.normalize(quats, eps=1e-12))
    p = projection.project_gaussians(means, cov, camera.world_view_transform,
                                     camera.full_proj_transform, camera.tanfovx, camera.tanfovy, W, H)
    dirs = means - camera.camera_center[None, :]
    norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs = dirs / torch.maximum(norm, norm.new_tensor(1e-12))
    rgb = sh.sh_to_rgb_clamped(3, shs, dirs)
    valid = (p["radius"] > 0)[:, None]
    return (torch.sum(torch.where(valid, p["mean2d"] * weights[0], 0.0))
            + torch.sum(torch.where(valid, p["conic"] * weights[1], 0.0)) + torch.sum(rgb * weights[2]))


@pytest.mark.parametrize("seed", [0, 1])
def test_core_gradients_match_jax(seed):
    args, w = _inputs(seed)
    R, T, fx, fy = _camera_args()
    jcam = JaxCamera.from_Rt(R, T, fx, fy, W, H)
    cam = Camera.from_Rt(R, T, fx, fy, W, H, device="cpu")
    with jax.disable_jit():
        want = jax.grad(lambda *a: _jax_loss(jcam, [jnp.asarray(x) for x in w], *a),
                        argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    _port_loss(cam, [torch.from_numpy(x) for x in w], *leaves).backward()
    for name, leaf, wv in zip(("means", "scales", "quats", "shs"), leaves, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(leaf.grad.numpy(), wv, rtol=1e-4,
                                   atol=1e-6 * np.abs(wv).max(), err_msg=name)
    assert not leaves[3].grad[:40, 0].any(), "clamped colours pass no gradient"
