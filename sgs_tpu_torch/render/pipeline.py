"""Public render(). Port of `render()` in `sgs_tpu/render/pipeline.py`:
mode="tiled" (binning with tight culling and Kernel A), mode="rect" (the
same with the full 3-sigma rect binning, JAX's `--no-tight_culling`) or
mode="reference" (the O(N*P) oracle, `render/reference.py`), with
`scaling_modifier` and the `cov3d_precomp` / `colors_precomp` alternatives.

Returned dict keys match the reference renderer: render (3,H,W) f32,
viewspace_points (the screen-space tap), visibility_filter (N,) bool,
radii (N,) int32, and overflow (always 0: the port sizes every array from
the real counts). n_instances adds the (Gaussian, tile) count of a tiled
view (0 for the oracle, which bins nothing).
"""

from __future__ import annotations

import torch

from sgs_tpu_torch.core import sh as sh_lib
from sgs_tpu_torch.core import transforms
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import project_gaussians
from sgs_tpu_torch.models.gaussians import GaussianInputs
from sgs_tpu_torch.render import reference
from sgs_tpu_torch.render.tiled import rasterize_tiled

MODES = ("tiled", "rect", "reference")


def project_and_shade(camera: Camera, gaussians: GaussianInputs,
                      scaling_modifier: float = 1.0) -> dict:
    """Covariance, projection and SH -> RGB: the rasterizer's inputs.
    Returns mean2d, depth, conic, radius, rgb, opacity (N,) and valid.
    cov3d_precomp replaces the covariance from scales and rotations, and
    colors_precomp the SH colours."""
    g = gaussians
    if g.cov3d_precomp is not None:
        cov3d = g.cov3d_precomp
    else:
        cov3d = transforms.build_covariance(g.scales, g.rotations, scaling_modifier)
    proj = project_gaussians(
        g.means3d, cov3d, camera.world_view_transform, camera.full_proj_transform,
        camera.tanfovx, camera.tanfovy, camera.image_width, camera.image_height,
    )
    if g.colors_precomp is not None:
        rgb = g.colors_precomp
    else:
        dirs = g.means3d - camera.camera_center[None, :]
        norm = torch.linalg.vector_norm(dirs, dim=-1, keepdim=True)
        dirs = dirs / torch.maximum(norm, norm.new_tensor(1e-12))
        rgb = sh_lib.sh_to_rgb_clamped(g.sh_degree, g.shs, dirs)
    valid = proj["radius"] > 0
    if g.alive is not None:
        valid = valid & g.alive
    return {
        "mean2d": proj["mean2d"],
        "depth": proj["depth"],
        "conic": proj["conic"],
        "radius": proj["radius"],
        "rgb": rgb,
        "opacity": g.opacities[..., 0],
        "valid": valid,
    }


def render(camera: Camera, gaussians: GaussianInputs, bg_color: torch.Tensor,
           scaling_modifier: float = 1.0, vspace_tap: "torch.Tensor | None" = None,
           mode: str = "tiled", pixel_block: int = reference.PIXEL_BLOCK) -> dict:
    """Projection and shading, then the rasterizer of `mode` and the
    background through the final transmittance. "tiled" bins tightly and
    composites with Kernel A (differentiable through Kernel C), "rect"
    bins each Gaussian's whole rect (the same pixels, more instances);
    "reference"
    composites every pixel against every Gaussian, `pixel_block` pixels
    at a time (differentiable by autograd).

    vspace_tap (N, 3), zeros, is the screen-space tap: mean2d gets
    tap[:, :2] * (W/2, H/2) added, so the loss's gradient with respect to
    the tap is the NDC-space mean gradient that the densify statistics
    read (the units of the CUDA reference's screenspace_points.grad)."""
    if mode not in MODES:
        raise ValueError(f"unknown rasterizer mode {mode!r}")
    p = project_and_shade(camera, gaussians, scaling_modifier)
    n = p["mean2d"].shape[0]
    dev = p["mean2d"].device
    if vspace_tap is None:
        vspace_tap = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    half_size = torch.tensor([0.5 * camera.image_width, 0.5 * camera.image_height],
                             dtype=torch.float32, device=dev)
    mean2d = p["mean2d"] + vspace_tap[:, :2] * half_size[None, :]
    if mode != "reference":
        image, aux = rasterize_tiled(
            mean2d, p["depth"], p["conic"], p["rgb"], p["opacity"], p["radius"], p["valid"],
            bg_color, camera.image_width, camera.image_height, tight=mode == "tiled",
        )
        n_instances = aux["n_instances"]
    else:
        image = reference.rasterize_sorted(
            mean2d, p["depth"], p["conic"], p["rgb"], p["opacity"], p["valid"], bg_color,
            camera.image_width, camera.image_height, radius=p["radius"],
            pixel_block=pixel_block,
        )
        n_instances = 0
    radii = torch.where(p["valid"], p["radius"], torch.zeros_like(p["radius"]))
    return {
        "render": image,
        "viewspace_points": vspace_tap,
        "visibility_filter": radii > 0,
        "radii": radii,
        "overflow": 0,
        "n_instances": n_instances,
    }
