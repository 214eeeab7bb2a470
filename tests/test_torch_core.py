"""Port parity: SH, transforms and projection (sgs_tpu_torch.core) against
sgs_tpu.core on seeded random inputs, on the CPU."""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sgs_tpu.core import projection as jproj
from sgs_tpu.core import sh as jsh
from sgs_tpu.core import transforms as jtr
from sgs_tpu_torch.core import projection, sh, transforms

torch.set_num_threads(1)
ATOL = 1e-6


def _unit_dirs(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_basis_matches_jax(degree):
    dirs = _unit_dirs(np.random.default_rng(degree), 500)
    want = np.asarray(jsh.sh_basis(degree, jnp.asarray(dirs)))
    got = sh.sh_basis(degree, torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_to_rgb_clamped_matches_jax(degree):
    rng = np.random.default_rng(10 + degree)
    dirs = _unit_dirs(rng, 400)
    coeffs = rng.normal(0, 0.5, (400, 16, 3)).astype(np.float32)
    want = np.asarray(jsh.sh_to_rgb_clamped(degree, jnp.asarray(coeffs), jnp.asarray(dirs)))
    got = sh.sh_to_rgb_clamped(degree, torch.from_numpy(coeffs), torch.from_numpy(dirs)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert (got >= 0).all()


def test_sh_degree_out_of_range_raises():
    with pytest.raises(ValueError):
        sh.sh_basis(5, torch.zeros(1, 3))


def test_transforms_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(300, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-4, 0, (300, 3))).astype(np.float32)
    qt, st = torch.from_numpy(q), torch.from_numpy(s)
    np.testing.assert_allclose(
        transforms.normalize(qt).numpy(), np.asarray(jtr.normalize(jnp.asarray(q))), atol=ATOL, rtol=0
    )
    np.testing.assert_allclose(
        transforms.normalize(qt, eps=1e-12).numpy(),
        np.asarray(jtr.normalize(jnp.asarray(q), eps=1e-12)), atol=ATOL, rtol=0,
    )
    np.testing.assert_allclose(
        transforms.quat_to_rotmat(qt).numpy(), np.asarray(jtr.quat_to_rotmat(jnp.asarray(q))),
        atol=ATOL, rtol=0,
    )
    for mod in (1.0, 0.5):
        np.testing.assert_allclose(
            transforms.build_covariance(st, qt, mod).numpy(),
            np.asarray(jtr.build_covariance(jnp.asarray(s), jnp.asarray(q), mod)),
            atol=ATOL, rtol=0,
        )


def _random_camera(rng):
    """A look-at camera about 4 units from the origin, COLMAP convention."""
    eye = rng.normal(size=3)
    eye = 4.0 * eye / np.linalg.norm(eye)
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    w2c_rot = np.stack([right, down, fwd])
    R = w2c_rot.T
    T = -w2c_rot @ eye
    return R, T


def test_camera_matrices_match_jax():
    rng = np.random.default_rng(4)
    R, T = _random_camera(rng)
    np.testing.assert_array_equal(projection.world_to_view(R, T), jproj.world_to_view(R, T))
    np.testing.assert_array_equal(
        projection.perspective_projection(0.01, 100.0, 0.8, 0.6),
        jproj.perspective_projection(0.01, 100.0, 0.8, 0.6),
    )
    assert projection.fov2focal(0.7, 800) == jproj.fov2focal(0.7, 800)
    assert projection.focal2fov(1111.0, 800) == jproj.focal2fov(1111.0, 800)
    assert projection.focal2fov(projection.fov2focal(0.7, 800), 800) == pytest.approx(0.7)


@pytest.mark.parametrize("seed", [0, 1])
def test_project_gaussians_matches_jax(seed):
    rng = np.random.default_rng(20 + seed)
    n, width, height = 600, 120, 90
    R, T = _random_camera(rng)
    fovx = 0.9
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    view = projection.world_to_view(R, T)
    proj = projection.perspective_projection(0.01, 100.0, fovx, fovy)
    view_T = view.T.astype(np.float32)
    full_T = (proj @ view).T.astype(np.float32)
    tx = np.float32(math.tan(fovx / 2))
    ty = np.float32(math.tan(fovy / 2))
    means = rng.normal(0, 1.2, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = np.exp(rng.uniform(-5, -1, (n, 3))).astype(np.float32)
    cov = np.array(jtr.build_covariance(jnp.asarray(s), jnp.asarray(q)))

    want = jproj.project_gaussians(
        jnp.asarray(means), jnp.asarray(cov), jnp.asarray(view_T), jnp.asarray(full_T),
        jnp.float32(tx), jnp.float32(ty), width, height,
    )
    got = projection.project_gaussians(
        torch.from_numpy(means), torch.from_numpy(cov), torch.from_numpy(view_T),
        torch.from_numpy(full_T), torch.tensor(tx), torch.tensor(ty), width, height,
    )
    assert got["radius"].dtype == torch.int32
    np.testing.assert_array_equal(got["in_frustum"].numpy(), np.asarray(want["in_frustum"]))
    np.testing.assert_array_equal(got["radius"].numpy(), np.asarray(want["radius"]))
    vis = np.asarray(want["radius"]) > 0
    assert vis.sum() > n // 4
    for key in ("mean2d", "depth", "conic", "cov2d"):
        w = np.asarray(want[key])[vis]
        g = got[key].numpy()[vis]
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0, err_msg=key)


def test_entry_points_refuse_missing_cuda(monkeypatch, tmp_path):
    """Entry points default to the card and raise without CUDA: no silent CPU path."""
    import os

    from sgs_tpu_torch.core.camera import Camera
    from sgs_tpu_torch.core.device import resolve_device
    from sgs_tpu_torch.metrics import evaluate
    from sgs_tpu_torch.models.gaussians import GaussianModel
    from sgs_tpu_torch.render.cli import render_sets
    from sgs_tpu_torch.utils.config import ModelParams, PipelineParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        Camera.from_Rt(np.eye(3), np.zeros(3), 0.8, 0.8, 32, 32)
    with pytest.raises(RuntimeError):
        GaussianModel.from_ply(os.path.join(root, "assets", "lgm", "point_cloud.ply"), 0)
    with pytest.raises(RuntimeError):
        render_sets(ModelParams(source_path=os.path.join(root, "data", "flagship800"),
                                model_path=str(tmp_path)), -1, PipelineParams(), False, False)
    with pytest.raises(RuntimeError):
        evaluate([str(tmp_path)])
    assert resolve_device("cpu") == torch.device("cpu")
