"""Port parity of the whole render -> metrics slice on the CPU.

A seeded 2,000-Gaussian subset of the flagship PLY goes into a JAX
GaussianPool (padded with dead slots, as the trainer keeps it) and across
to the port with `from_jax_arrays`. Two test views, at the flagship's FoV
and 200x200 pixels, are rendered by the port's `eval_render` and by the JAX
`eval_render` in tiled mode with the Pallas backend and tight culling
(Pallas in interpret mode), then scored against the same GT. Image to atol
3e-5; SSIM and PSNR to rtol 1e-5.

The JAX render runs op by op (`jax.disable_jit`): under jit, XLA's CPU
fusion contracts multiply-adds in the projection into fused ones, which
moves conics by up to 6e-4 and can flip an alpha across the 1/255 cut
(an image error near 4e-3 at a handful of pixels). Op by op, XLA rounds
each product and sum as PyTorch does, so the comparison holds the port's
own arithmetic to the bar."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.core.camera import Camera as JaxCamera
from sgs_tpu.data import readers
from sgs_tpu.data.ply import load_gaussian_ply
from sgs_tpu.data.scene import pool_from_arrays
from sgs_tpu.ops import ssim as jssim
from sgs_tpu.train.loop import eval_render as jax_eval_render
from sgs_tpu.train.loop import instance_bucket
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.models.gaussians import from_jax_arrays
from sgs_tpu_torch.ops import ssim
from sgs_tpu_torch.train.loop import eval_render

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_SUBSET, SIZE, VIEWS = 2000, 200, (0, 4)


@pytest.fixture(scope="module")
def pair():
    arrays = load_gaussian_ply(os.path.join(ROOT, "assets", "flagship", "point_cloud.ply"), 3)
    rng = np.random.default_rng(0)
    keep = np.sort(rng.choice(arrays["xyz"].shape[0], N_SUBSET, replace=False))
    pool = pool_from_arrays({k: v[keep] for k, v in arrays.items()}, 3)
    fields = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity", "alive")
    model = from_jax_arrays({f: np.array(getattr(pool, f)) for f in fields}, 3, device="cpu")
    infos = readers.read_cameras_from_transforms(
        os.path.join(ROOT, "data", "flagship800"), "transforms_test.json", False
    )
    return pool, model, infos


@pytest.mark.parametrize("view", VIEWS)
def test_slice_matches_jax(pair, view):
    pool, model, infos = pair
    info = infos[view]
    assert model.xyz.shape[0] > N_SUBSET and int(model.alive.sum()) == N_SUBSET
    jcam = JaxCamera.from_Rt(info.R, info.T, info.FovX, info.FovY, SIZE, SIZE)
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, SIZE, SIZE, device="cpu")
    mi, mr, mk = instance_bucket(pool, jcam, tight=True)
    with jax.disable_jit():
        want = np.asarray(jax_eval_render(
            pool, jcam, jnp.zeros(3), 3, mode="tiled", max_instances=mi, backend="pallas",
            max_row_instances=mr, max_kernel_rows=mk,
        ))
    got = eval_render(model, cam, torch.zeros(3), 3, "tiled")
    assert got.shape == (3, SIZE, SIZE)
    assert float(got.max()) > 0.1, "the subset should cover part of the view"
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=0)

    gt800 = np.asarray(info.image, np.float32).transpose(2, 0, 1) / 255.0
    gt = gt800.reshape(3, SIZE, 4, SIZE, 4).mean(axis=(2, 4)).astype(np.float32)
    gt_t, gt_j = torch.from_numpy(gt), jnp.asarray(gt)
    np.testing.assert_allclose(
        float(ssim.ssim(got, gt_t)), float(jssim.ssim(jnp.asarray(want), gt_j)), rtol=1e-5
    )
    np.testing.assert_allclose(
        float(ssim.psnr(got, gt_t)), float(jssim.psnr(jnp.asarray(want), gt_j)), rtol=1e-5
    )
