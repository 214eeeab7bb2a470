"""Public render(): the tiled forward path. Port of `render()` in
`sgs_tpu/render/pipeline.py` for mode="tiled" with tight culling.

Returned dict keys match the reference renderer: render (3,H,W) f32,
viewspace_points (the zero screen-space tap), visibility_filter (N,) bool,
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
    dirs = dirs / torch.clamp_min(torch.linalg.vector_norm(dirs, dim=-1, keepdim=True), 1e-12)
    return {
        "mean2d": proj["mean2d"],
        "depth": proj["depth"],
        "conic": proj["conic"],
        "radius": proj["radius"],
        "rgb": sh_lib.sh_to_rgb_clamped(g.sh_degree, g.shs, dirs),
        "opacity": g.opacities[..., 0],
        "valid": (proj["radius"] > 0) & g.alive,
    }


def render(camera: Camera, gaussians: GaussianInputs, bg_color: torch.Tensor) -> dict:
    """Projection and shading, binning and Kernel A, then the background
    through t_final."""
    p = project_and_shade(camera, gaussians)
    image, aux = rasterize_tiled(
        p["mean2d"], p["depth"], p["conic"], p["rgb"], p["opacity"], p["radius"], p["valid"],
        bg_color, camera.image_width, camera.image_height,
    )
    radii = torch.where(p["valid"], p["radius"], torch.zeros_like(p["radius"]))
    n = p["mean2d"].shape[0]
    return {
        "render": image,
        "viewspace_points": torch.zeros((n, 3), dtype=torch.float32, device=p["mean2d"].device),
        "visibility_filter": radii > 0,
        "radii": radii,
        "overflow": 0,
        "n_instances": aux["n_instances"],
    }
