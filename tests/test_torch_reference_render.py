"""The port's reference rasterizer (`render/reference.py`) and the render
alternatives (`render/pipeline.py`) against the JAX package's on the CPU.

Mirrors tests/test_reference_render.py: random scenes at chunk sizes 4,
16 and 256 against JAX's `rasterize_sorted` and the per-pixel loop of
tests/brute_force.py; one Gaussian's analytic centre pixel; the empty
scene's exact background; the render contract. Images within 3e-5 of
JAX's. Also: the oracle against the port's tiled path (Kernel A's plain
version) on one scene, and `scaling_modifier`, `cov3d_precomp` and
`colors_precomp` against JAX's `render` in both modes. The gradients are
in tests/test_torch_reference_grad.py.

JAX's `rasterize_sorted` runs jitted here (its own tests do): its inputs
are the same arrays as the port's, so XLA's fused products can only move
the image by f32 rounding.
"""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.core import projection as jproj
from sgs_tpu.core import transforms as jtransforms
from sgs_tpu.core.camera import Camera as JaxCamera
from sgs_tpu.render import GaussianInputs as JaxInputs
from sgs_tpu.render import render as jax_render
from sgs_tpu.render.reference import rasterize_sorted as jax_rasterize_sorted
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.data.ply import load_gaussian_ply
from sgs_tpu_torch.data.readers import read_cameras_from_transforms
from sgs_tpu_torch.models.gaussians import GaussianInputs, from_jax_arrays
from sgs_tpu_torch.render.pipeline import project_and_shade, render
from sgs_tpu_torch.render.reference import rasterize_sorted

from brute_force import brute_force_render

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGE_ATOL = 3e-5
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-6


def cameras(width=40, height=32, fovx=math.radians(60)):
    fovy = jproj.focal2fov(jproj.fov2focal(fovx, width), height)
    return (JaxCamera.from_Rt(np.eye(3), np.zeros(3), fovx, fovy, width, height),
            Camera.from_Rt(np.eye(3), np.zeros(3), fovx, fovy, width, height, device="cpu"))


def random_scene(n=40, seed=0, spread=1.0, zmin=2.0, zmax=8.0):
    """tests/test_reference_render.py's scene."""
    rng = np.random.default_rng(seed)
    means = np.stack([rng.uniform(-spread, spread, n), rng.uniform(-spread, spread, n),
                      rng.uniform(zmin, zmax, n)], axis=-1).astype(np.float32)
    scales = np.exp(rng.uniform(-3.0, -1.0, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacity = rng.uniform(0.2, 0.95, (n, 1)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
    return means, scales, quats, opacity, colors


def projected(jcam, means, scales, quats):
    """JAX's projection of the scene as numpy arrays: both oracles get the
    same inputs."""
    cov3d = jtransforms.build_covariance(jnp.asarray(scales), jnp.asarray(quats))
    p = jproj.project_gaussians(jnp.asarray(means), cov3d, jcam.world_view_transform,
                                jcam.full_proj_transform, jcam.tanfovx, jcam.tanfovy,
                                jcam.image_width, jcam.image_height)
    return {k: np.array(p[k]) for k in ("mean2d", "depth", "conic", "radius")}


def terminating_scene(seed=1):
    """60 Gaussians, ten of them at opacity 0.99 so pixels stop early."""
    jcam, cam = cameras()
    means, scales, quats, opacity, colors = random_scene(60, seed=seed)
    opacity[:10] = 0.99
    p = projected(jcam, means, scales, quats)
    p.update(rgb=colors, opacity=opacity[:, 0], valid=p["radius"] > 0,
             bg=np.array([0.1, 0.2, 0.3], np.float32))
    return jcam, cam, p


def both(p, width, height, chunk_size=256, pixel_block=128, radius=True):
    keys = ("mean2d", "depth", "conic", "rgb", "opacity", "valid", "bg")
    want = jax_rasterize_sorted(*(jnp.asarray(p[k]) for k in keys), width, height,
                                radius=jnp.asarray(p["radius"]) if radius else None,
                                chunk_size=chunk_size, pixel_block=pixel_block)
    got = rasterize_sorted(*(torch.as_tensor(p[k]) for k in keys), width, height,
                           radius=torch.as_tensor(p["radius"]) if radius else None,
                           chunk_size=chunk_size, pixel_block=pixel_block)
    return got.numpy(), np.asarray(want)


def close_grad(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_SCALE * float(np.abs(want).max()), err_msg=name)


@pytest.mark.parametrize("chunk_size", [4, 16, 256])
def test_matches_jax_and_brute_force(chunk_size):
    jcam, _, p = terminating_scene()
    assert p["valid"].sum() > 10
    got, want = both(p, 40, 32, chunk_size=chunk_size)
    assert got.shape == (3, 32, 40)
    np.testing.assert_allclose(got, want, atol=IMAGE_ATOL, rtol=0)
    expected = brute_force_render(p["mean2d"], p["depth"], p["conic"], p["rgb"], p["opacity"],
                                  p["valid"], p["bg"], 40, 32, radius=p["radius"])
    np.testing.assert_allclose(got, expected, atol=2e-5, rtol=0)


def test_block_and_chunk_sizes_only_reorder():
    _, _, p = terminating_scene(seed=3)
    got, _ = both(p, 40, 32, chunk_size=7, pixel_block=100)
    ref, _ = both(p, 40, 32, chunk_size=256, pixel_block=1 << 16)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_unbounded_rect_matches_jax():
    _, _, p = terminating_scene(seed=4)
    got, want = both(p, 40, 32, chunk_size=16, radius=False)
    np.testing.assert_allclose(got, want, atol=IMAGE_ATOL, rtol=0)


def test_single_gaussian_analytic():
    """One isotropic Gaussian at the image centre: the centre pixel is
    alpha * colour, the next one alpha = op * exp(-0.5 / var)."""
    jcam, _ = cameras(33, 33)
    s, z, op = 0.1, 4.0, 0.8
    focal = jproj.fov2focal(math.radians(60), 33)
    p = projected(jcam, np.array([[0.0, 0.0, z]], np.float32), np.full((1, 3), s, np.float32),
                  np.array([[1, 0, 0, 0]], np.float32))
    color = np.array([[1.0, 0.5, 0.25]], np.float32)
    img = rasterize_sorted(torch.as_tensor(p["mean2d"]), torch.as_tensor(p["depth"]),
                           torch.as_tensor(p["conic"]), torch.as_tensor(color), torch.tensor([op]),
                           torch.tensor([True]), torch.zeros(3), 33, 33).numpy()
    np.testing.assert_allclose(img[:, 16, 16], op * color[0], rtol=1e-5)
    var = (focal * s / z) ** 2 + 0.3
    np.testing.assert_allclose(img[:, 16, 17], op * math.exp(-0.5 / var) * color[0], rtol=1e-4)


def test_empty_scene_renders_background():
    bg = torch.tensor([0.3, 0.6, 0.9])
    img = rasterize_sorted(torch.zeros((4, 2)), torch.ones(4), torch.ones((4, 3)), torch.ones((4, 3)),
                           torch.ones(4), torch.zeros(4, dtype=torch.bool), bg, 8, 8)
    assert torch.equal(img, bg[:, None, None].expand(3, 8, 8))


def scene_inputs(scene, mode, cov3d=None, colors=False, device="cpu"):
    """(JAX inputs, port inputs) of a random scene: scales and rotations or
    `cov3d`, SH degree 1 or the scene's colours."""
    means, scales, quats, opacity, rgb = scene
    shs = np.random.default_rng(9).normal(0, 0.4, (means.shape[0], 4, 3)).astype(np.float32)
    kw = {"means3d": means, "opacities": opacity}
    kw.update({"cov3d_precomp": cov3d} if cov3d is not None else {"scales": scales, "rotations": quats})
    kw.update({"colors_precomp": rgb} if colors else {"shs": shs})
    jin = JaxInputs(**{k: jnp.asarray(v) for k, v in kw.items()}, sh_degree=1)
    tin = GaussianInputs(**{k: torch.tensor(v, device=device) for k, v in kw.items()},
                         sh_degree=1)
    return jin, tin


@pytest.mark.parametrize("mode", ["reference", "tiled"])
@pytest.mark.parametrize("case", ["plain", "scaling_modifier", "cov3d_precomp", "colors_precomp"])
def test_render_alternatives_match_jax(mode, case):
    jcam, cam = cameras(48, 40)
    scene = random_scene(50, seed=8)
    cov3d = None
    if case == "cov3d_precomp":
        cov3d = np.asarray(jtransforms.build_covariance(jnp.asarray(scene[1] * 1.3),
                                                        jnp.asarray(scene[2])))
    jin, tin = scene_inputs(scene, mode, cov3d=cov3d, colors=case == "colors_precomp")
    modifier = 0.6 if case == "scaling_modifier" else 1.0
    bg = np.array([0.2, 0.1, 0.4], np.float32)
    want = jax_render(jcam, jin, jnp.asarray(bg), scaling_modifier=modifier, mode=mode)
    got = render(cam, tin, torch.from_numpy(bg), scaling_modifier=modifier, mode=mode)
    assert sorted(got) == sorted([*want, "n_instances"])
    np.testing.assert_allclose(got["render"].numpy(), np.asarray(want["render"]),
                               atol=IMAGE_ATOL, rtol=0)
    assert got["radii"].dtype == torch.int32
    np.testing.assert_array_equal(got["radii"].numpy(), np.asarray(want["radii"]))
    assert torch.equal(got["visibility_filter"], got["radii"] > 0)
    assert bool(got["visibility_filter"].any())


def test_oracle_matches_the_tiled_path():
    """The port's oracle against its tiled path (binning and Kernel A's
    plain version) on a flagship subset: nothing shared but projection."""
    arrays = load_gaussian_ply(os.path.join(ROOT, "assets", "flagship", "point_cloud.ply"), 3)
    keep = np.sort(np.random.default_rng(0).choice(arrays["xyz"].shape[0], 1500, replace=False))
    model = from_jax_arrays({k: v[keep] for k, v in arrays.items()}, 3, device="cpu")
    info = read_cameras_from_transforms(os.path.join(ROOT, "data", "flagship800"),
                                        "transforms_test.json", False)[0]
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, 96, 96, device="cpu")
    inputs = model.render_inputs(3)
    ref = render(cam, inputs, torch.zeros(3), mode="reference")
    tiled = render(cam, inputs, torch.zeros(3), mode="tiled")
    assert float(ref["render"].max()) > 0.1 and tiled["n_instances"] > 0
    np.testing.assert_allclose(ref["render"].numpy(), tiled["render"].numpy(), atol=IMAGE_ATOL, rtol=0)


def test_explain_pixels_replays_both_arrangements():
    """`tools/oracle_times.py::explain_pixels`, which chip_smoke.py phase 12
    uses to account for the pixels where the oracle and Kernel A differ
    past the bar: none here; a pixel moved by 1e-3 in the tiled image is
    reported, not accounted for, with its replay at the unmoved value."""
    from sgs_tpu_torch.render.tiled import bin_gaussians
    from sgs_tpu_torch.tools import oracle_times

    arrays = load_gaussian_ply(os.path.join(ROOT, "assets", "flagship", "point_cloud.ply"), 3)
    keep = np.sort(np.random.default_rng(1).choice(arrays["xyz"].shape[0], 1500, replace=False))
    model = from_jax_arrays({k: v[keep] for k, v in arrays.items()}, 3, device="cpu")
    info = read_cameras_from_transforms(os.path.join(ROOT, "data", "flagship800"),
                                        "transforms_test.json", False)[1]
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, 64, 64, device="cpu")
    inputs = model.render_inputs(3)
    p = project_and_shade(cam, inputs)
    bins = bin_gaussians(p["mean2d"], p["conic"], p["opacity"], p["depth"], p["radius"], p["valid"], 64, 64)
    ref = render(cam, inputs, torch.zeros(3), mode="reference")["render"]
    tiled = render(cam, inputs, torch.zeros(3), mode="tiled")["render"]
    assert oracle_times.explain_pixels(p, bins, ref, tiled) == []
    moved = tiled.clone()
    moved[:, 40, 30] += 1e-3
    (m,) = oracle_times.explain_pixels(p, bins, ref, moved)
    assert m["pixel"] == (30, 40) and not m["explained"] and m["dropped"] == []
    np.testing.assert_allclose(m["seq_a"], tiled[:, 40, 30].numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(m["seq_oracle"], ref[:, 40, 30].numpy(), atol=1e-6, rtol=0)
