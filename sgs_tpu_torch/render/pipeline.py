"""Public render(): the tiled forward path. Port of `render()` in
`sgs_tpu/render/pipeline.py` for mode="tiled" with tight culling.

Returned dict keys match the reference renderer: render (3,H,W) f32,
viewspace_points (the screen-space tap), visibility_filter (N,) bool,
radii (N,) int32, and overflow (always 0: the port sizes every array from
the real counts). n_instances adds the (Gaussian, tile) count of the view.
"""

from __future__ import annotations

import torch

from sgs_tpu_torch.core import sh as sh_lib
from sgs_tpu_torch.core import transforms
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import project_gaussians
from sgs_tpu_torch.models.gaussians import GaussianInputs
from sgs_tpu_torch.render.tiled import rasterize_tiled


def project_and_shade(camera: Camera, gaussians: GaussianInputs) -> dict:
    """Covariance, projection and SH -> RGB: the rasterizer's inputs.
    Returns mean2d, depth, conic, radius, rgb, opacity (N,) and valid."""
    g = gaussians
    cov3d = transforms.build_covariance(g.scales, g.rotations)
    proj = project_gaussians(
        g.means3d, cov3d, camera.world_view_transform, camera.full_proj_transform,
        camera.tanfovx, camera.tanfovy, camera.image_width, camera.image_height,
    )
    dirs = g.means3d - camera.camera_center[None, :]
    norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
    dirs = dirs / torch.maximum(norm, norm.new_tensor(1e-12))
    return {
        "mean2d": proj["mean2d"],
        "depth": proj["depth"],
        "conic": proj["conic"],
        "radius": proj["radius"],
        "rgb": sh_lib.sh_to_rgb_clamped(g.sh_degree, g.shs, dirs),
        "opacity": g.opacities[..., 0],
        "valid": (proj["radius"] > 0) & g.alive,
    }


def render(camera: Camera, gaussians: GaussianInputs, bg_color: torch.Tensor,
           vspace_tap: "torch.Tensor | None" = None) -> dict:
    """Projection and shading, binning and Kernel A, then the background
    through t_final.

    vspace_tap (N, 3), zeros, is the screen-space tap: mean2d gets
    tap[:, :2] * (W/2, H/2) added, so the loss's gradient with respect to
    the tap is the NDC-space mean gradient that the densify statistics
    read (the units of the CUDA reference's screenspace_points.grad)."""
    p = project_and_shade(camera, gaussians)
    n = p["mean2d"].shape[0]
    dev = p["mean2d"].device
    if vspace_tap is None:
        vspace_tap = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    half_size = torch.tensor([0.5 * camera.image_width, 0.5 * camera.image_height],
                             dtype=torch.float32, device=dev)
    mean2d = p["mean2d"] + vspace_tap[:, :2] * half_size[None, :]
    image, aux = rasterize_tiled(
        mean2d, p["depth"], p["conic"], p["rgb"], p["opacity"], p["radius"], p["valid"],
        bg_color, camera.image_width, camera.image_height,
    )
    radii = torch.where(p["valid"], p["radius"], torch.zeros_like(p["radius"]))
    return {
        "render": image,
        "viewspace_points": vspace_tap,
        "visibility_filter": radii > 0,
        "radii": radii,
        "overflow": 0,
        "n_instances": aux["n_instances"],
    }
