"""Synthetic datasets for tests and benchmarks. Port of
`sgs_tpu/utils/toy_scene.py`.

A ground-truth Gaussian scene is sampled with numpy in the JAX package's
draw order (the same seed gives the same Gaussians), its views on a
camera circle are rendered with the oracle (`render(mode="reference")`,
the JAX function's default) and written as a Blender-format dataset
(`transforms_{train,test}.json` and PNGs through `data/png.py`) or a
COLMAP binary one (through `tools/colmap_scene.py`'s writer). The GT
renders run on `device` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import focal2fov, fov2focal
from sgs_tpu_torch.data.png import write_png
from sgs_tpu_torch.models.gaussians import GaussianInputs
from sgs_tpu_torch.render.pipeline import render


def sample_gt_gaussians(n: int = 300, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    # A blobby object inside [-1, 1]^3 with position-correlated colors.
    centers = rng.normal(size=(8, 3)) * 0.45
    which = rng.integers(0, len(centers), n)
    pts = centers[which] + rng.normal(size=(n, 3)) * 0.18
    colors = np.clip(0.5 + 0.45 * pts + rng.normal(size=(n, 3)) * 0.08, 0.02, 0.98)
    scales = np.exp(rng.uniform(-3.6, -2.4, (n, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacity = rng.uniform(0.55, 0.95, (n, 1))
    return {
        "means3d": pts.astype(np.float32),
        "scales": scales.astype(np.float32),
        "rotations": quats.astype(np.float32),
        "opacity": opacity.astype(np.float32),
        "colors": colors.astype(np.float32),
    }


def sample_gt_gaussians_hard(n: int = 4000, seed: int = 0) -> dict:
    """Harder GT: a textured occluding shell over an inner core, thin
    anisotropic splats and a high-frequency colour texture."""
    rng = np.random.default_rng(seed)
    n_shell = int(n * 0.7)
    n_core = n - n_shell
    # bumpy sphere shell, radius ~0.9 with lumps
    u = rng.normal(size=(n_shell, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    bump = 0.9 + 0.12 * np.sin(5.0 * u[:, 0:1] * 3.1) * np.cos(4.0 * u[:, 1:2] * 2.7)
    shell = u * bump
    core = rng.normal(size=(n_core, 3)) * 0.3
    pts = np.concatenate([shell, core])
    # high-frequency multi-band texture
    phase = pts @ np.array([[7.1, 2.3, 5.9], [1.7, 9.2, 3.1], [4.3, 2.9, 8.7]]).T
    colors = np.clip(
        0.5
        + 0.35 * np.sin(phase)
        + 0.12 * np.sin(3.7 * phase[:, [1, 2, 0]])
        + rng.normal(size=(n, 3)) * 0.03,
        0.02,
        0.98,
    )
    # thin anisotropic shell splats (flattened along the normal)
    log_s = rng.uniform(-4.4, -3.2, (n, 3))
    log_s[:n_shell, 0] -= 1.2  # flatten one axis
    scales = np.exp(log_s)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opacity = np.concatenate(
        [rng.uniform(0.75, 0.98, (n_shell, 1)), rng.uniform(0.4, 0.9, (n_core, 1))]
    )
    return {
        "means3d": pts.astype(np.float32),
        "scales": scales.astype(np.float32),
        "rotations": quats.astype(np.float32),
        "opacity": opacity.astype(np.float32),
        "colors": colors.astype(np.float32),
    }


def circle_pose(theta: float, radius: float = 3.2, height: float = 0.6) -> np.ndarray:
    """Camera-to-world matrix (COLMAP convention: x right, y down, z forward)
    on a circle looking at the origin."""
    eye = np.array([radius * math.cos(theta), height, radius * math.sin(theta)])
    forward = -eye / np.linalg.norm(eye)  # toward origin
    world_up = np.array([0.0, -1.0, 0.0])  # y down convention
    right = np.cross(world_up, forward)
    right /= np.linalg.norm(right)
    down = np.cross(forward, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, forward, eye
    return c2w


def camera_from_c2w(c2w: np.ndarray, fovx: float, width: int, height: int,
                    device: "str | torch.device" = "cuda") -> Camera:
    w2c = np.linalg.inv(c2w)
    R = w2c[:3, :3].T
    T = w2c[:3, 3]
    fovy = focal2fov(fov2focal(fovx, width), height)
    return Camera.from_Rt(R, T, fovx, fovy, width, height, device=device)


def render_gt(gt: dict, camera: Camera, bg=(1.0, 1.0, 1.0)) -> np.ndarray:
    """(3, H, W) float image of the GT Gaussians through the oracle."""
    dev = camera.world_view_transform.device

    def t(a):
        return torch.as_tensor(a, device=dev)

    with torch.no_grad():
        out = render(
            camera,
            GaussianInputs(means3d=t(gt["means3d"]), opacities=t(gt["opacity"]), scales=t(gt["scales"]),
                           rotations=t(gt["rotations"]), colors_precomp=t(gt["colors"])),
            torch.tensor(bg, dtype=torch.float32, device=dev),
            mode="reference",
        )
    return np.clip(out["render"].cpu().numpy(), 0.0, 1.0)


def to_u8(img: np.ndarray) -> np.ndarray:
    """(3, H, W) float in [0, 1] -> (H, W, 3) uint8, truncated as PIL's
    `Image.fromarray((img * 255).astype(np.uint8))` writes it."""
    return (img.transpose(1, 2, 0) * 255).astype(np.uint8)


def make_blender_dataset(
    out_dir: str,
    n_train: int = 16,
    n_test: int = 4,
    width: int = 64,
    height: int = 64,
    n_gaussians: int = 300,
    seed: int = 0,
    white_background: bool = True,
    fovx: float = math.radians(50.0),
    variant: str = "blobby",  # "blobby" | "hard" (textured occluding shell)
    device: "str | torch.device" = "cuda",
) -> dict:
    """Write a Blender-format dataset; returns the GT gaussian dict."""
    sampler = sample_gt_gaussians_hard if variant == "hard" else sample_gt_gaussians
    gt = sampler(n_gaussians, seed)
    bg = (1.0, 1.0, 1.0) if white_background else (0.0, 0.0, 0.0)

    for split, count, offset in (("train", n_train, 0.0), ("test", n_test, 0.123)):
        frames = []
        split_dir = os.path.join(out_dir, split)
        os.makedirs(split_dir, exist_ok=True)
        for i in range(count):
            theta = 2 * math.pi * i / count + offset
            c2w = circle_pose(theta)
            cam = camera_from_c2w(c2w, fovx, width, height, device)
            write_png(os.path.join(split_dir, f"r_{i}.png"), to_u8(render_gt(gt, cam, bg)))
            # Blender JSON stores OpenGL-convention camera-to-world.
            c2w_gl = c2w.copy()
            c2w_gl[:3, 1:3] *= -1
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w_gl.tolist()})
        with open(os.path.join(out_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": fovx, "frames": frames}, f)
    return gt


def make_colmap_dataset(
    out_dir: str,
    n_views: int = 12,
    width: int = 64,
    height: int = 64,
    n_gaussians: int = 300,
    n_points: int = 400,
    seed: int = 0,
    device: "str | torch.device" = "cuda",
) -> dict:
    """Write a COLMAP binary-format dataset rendered from the same GT."""
    from sgs_tpu_torch.tools.colmap_scene import pinhole, write_sparse

    gt = sample_gt_gaussians(n_gaussians, seed)
    fovx = math.radians(50.0)
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    images = []
    for i in range(n_views):
        theta = 2 * math.pi * i / n_views
        c2w = circle_pose(theta)
        name = f"img_{i:03d}.png"
        cam = camera_from_c2w(c2w, fovx, width, height, device)
        write_png(os.path.join(out_dir, "images", name), to_u8(render_gt(gt, cam, (0.0, 0.0, 0.0))))
        images.append((name, np.linalg.inv(c2w)))

    rng = np.random.default_rng(seed + 1)
    idx = rng.integers(0, n_gaussians, n_points)
    pts = gt["means3d"][idx] + rng.normal(size=(n_points, 3)) * 0.02
    rgb = (gt["colors"][idx] * 255).astype(np.uint8)
    write_sparse(out_dir, pinhole(width, height, fovx), images, pts, rgb, binary=True)
    return gt
