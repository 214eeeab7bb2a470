"""Camera matrices and the per-Gaussian projection (EWA splatting) math.

Port of `sgs_tpu/core/projection.py`. Host-side matrix constructors stay in
numpy and keep the transposed (row-vector) convention: points transform as
`p_hom @ M`. `project_gaussians` reproduces the CUDA preprocess geometry:
frustum cull at view z <= 0.2, EWA local-affine 2D covariance with FoV
clamping and a 0.3-pixel low-pass, conic inversion, 3-sigma integer radius
and the NDC -> pixel map ((v+1)*S - 1)/2.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# CUDA auxiliary.h constants (public 3DGS rasterizer design).
TILE = 16
NEAR_CULL_Z = 0.2
COV2D_DILATION = 0.3
FOV_CLAMP = 1.3
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4

# Largest f32 below 2**31: clamping to it before an int32 cast reproduces
# the saturating float->int conversion of XLA.
_I32_HI = 2147483520.0


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """Truncating float -> int32 cast that saturates instead of wrapping."""
    return x.clamp(-2147483648.0, _I32_HI).to(torch.int32)


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 world->view matrix (column-vector form, NOT transposed).

    R is the camera-to-world rotation as stored by the loaders; t is the
    world->view translation.
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt.astype(np.float32)


def perspective_projection(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """4x4 perspective matrix (column-vector form), COLMAP z-forward."""
    tan_half_fovy = math.tan(fovy / 2)
    tan_half_fovx = math.tan(fovx / 2)
    top = tan_half_fovy * znear
    right = tan_half_fovx * znear
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = znear / right
    P[1, 1] = znear / top
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: float) -> float:
    return 2 * math.atan(pixels / (2 * focal))


def transform_points_hom(points: torch.Tensor, matrix_T: torch.Tensor) -> torch.Tensor:
    """(N,3) points through a TRANSPOSED 4x4 (row-vector convention) -> (N,4).

    Written as a pairwise sum, (x m0 + y m1) + (z m2 + m3): the order XLA's
    CPU dot uses for this contraction, so the CPU parity tests compare
    like with like."""
    x, y, z = points[..., 0:1], points[..., 1:2], points[..., 2:3]
    return (x * matrix_T[0] + y * matrix_T[1]) + (z * matrix_T[2] + matrix_T[3])


def ndc_to_pixel(ndc: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """CUDA ndc2Pix: ((v + 1) * S - 1) * 0.5 per axis."""
    size = torch.tensor([width, height], dtype=ndc.dtype, device=ndc.device)
    return ((ndc + 1.0) * size - 1.0) * 0.5


def tile_rect(mean2d: torch.Tensor, radius_f: torch.Tensor, tiles_x: int, tiles_y: int):
    """CUDA getRect: the [min, max) tile rectangle a 3-sigma disc touches."""
    min_x = to_i32((mean2d[..., 0] - radius_f) / TILE).clamp(0, tiles_x)
    max_x = to_i32((mean2d[..., 0] + radius_f + TILE - 1) / TILE).clamp(0, tiles_x)
    min_y = to_i32((mean2d[..., 1] - radius_f) / TILE).clamp(0, tiles_y)
    max_y = to_i32((mean2d[..., 1] + radius_f + TILE - 1) / TILE).clamp(0, tiles_y)
    return min_x, max_x, min_y, max_y


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    viewmatrix_T: torch.Tensor,
    projmatrix_T: torch.Tensor,
    tanfovx: torch.Tensor,
    tanfovy: torch.Tensor,
    width: int,
    height: int,
) -> dict:
    """The CUDA preprocess geometry stage, batched over all Gaussians.

    means3d (N,3), cov3d (N,6) stripped covariance, transposed world->view
    and world->clip matrices, f32 0-d tangents of the half FoVs. Returns
    mean2d (N,2), depth (N,), conic (N,3), radius (N,) int32 (0 = culled),
    in_frustum (N,) bool and the dilated cov2d (N,3).
    """
    p_view = transform_points_hom(means3d, viewmatrix_T)
    depth = p_view[..., 2]
    in_frustum = depth > NEAR_CULL_Z

    p_hom = transform_points_hom(means3d, projmatrix_T)
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    p_proj = p_hom[..., :3] * p_w[..., None]
    mean2d = ndc_to_pixel(p_proj[..., :2], width, height)

    # tensor / tensor: `int / tensor` would run as reciprocal-then-multiply
    focal_x = torch.full_like(tanfovx, width) / (2.0 * tanfovx)
    focal_y = torch.full_like(tanfovy, height) / (2.0 * tanfovy)

    # EWA: clamp the view-space direction to 1.3x the frustum before the
    # Jacobian (CUDA computeCov2D).
    tz = depth
    safe_tz = torch.where(tz.abs() < 1e-8, torch.full_like(tz, 1e-8), tz)
    limx, limy = FOV_CLAMP * tanfovx, FOV_CLAMP * tanfovy
    tx = torch.minimum(torch.maximum(p_view[..., 0] / safe_tz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(p_view[..., 1] / safe_tz, -limy), limy) * tz

    inv_tz = 1.0 / safe_tz
    inv_tz2 = inv_tz * inv_tz
    j00 = focal_x * inv_tz
    j02 = -focal_x * tx * inv_tz2
    j11 = focal_y * inv_tz
    j12 = -focal_y * ty * inv_tz2

    W3 = viewmatrix_T[:3, :3].T  # (3,3) world->view rotation, rows
    m0 = j00[..., None] * W3[0] + j02[..., None] * W3[2]
    m1 = j11[..., None] * W3[1] + j12[..., None] * W3[2]

    sigma = _unstrip(cov3d)  # (N, 3, 3)
    s_m0 = _fma_dot3(sigma, m0[:, None, :])
    s_m1 = _fma_dot3(sigma, m1[:, None, :])
    c_xx = _sum3(m0 * s_m0) + COV2D_DILATION
    c_xy = _sum3(m0 * s_m1)
    c_yy = _sum3(m1 * s_m1) + COV2D_DILATION

    det = c_xx * c_yy - c_xy * c_xy
    det_valid = det != 0.0
    safe_det = torch.where(det_valid, det, torch.ones_like(det))
    inv_det = 1.0 / safe_det
    conic = torch.stack([c_yy * inv_det, -c_xy * inv_det, c_xx * inv_det], dim=-1)

    mid = 0.5 * (c_xx + c_yy)
    lam1 = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam1, 0.0)))

    # CUDA getRect cull: a Gaussian overlapping zero on-screen tiles keeps
    # radius 0 and is excluded from visibility_filter.
    tiles_x = (width + TILE - 1) // TILE
    tiles_y = (height + TILE - 1) // TILE
    min_x, max_x, min_y, max_y = tile_rect(mean2d, radius_f, tiles_x, tiles_y)
    nonempty_rect = (max_x > min_x) & (max_y > min_y)

    visible = in_frustum & det_valid & nonempty_rect
    radius = torch.where(visible, radius_f, torch.zeros_like(radius_f)).to(torch.int32)

    return {
        "mean2d": mean2d,
        "depth": depth,
        "conic": conic,
        "radius": radius,
        "in_frustum": in_frustum,
        "cov2d": torch.stack([c_xx, c_xy, c_yy], dim=-1),
    }


def _sum3(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of length 3, left to right."""
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a_k b_k over a last axis of length 3 as the fused multiply-add
    chain fma(a2, b2, fma(a1, b1, a0 b0)), the order of the JAX matvec.
    Each fma is taken in float64, where the product of two f32 is exact,
    and rounded once to f32."""
    a64, b64 = a.double(), b.double()
    acc = (a64[..., 0] * b64[..., 0]).float()
    acc = (a64[..., 1] * b64[..., 1] + acc.double()).float()
    return (a64[..., 2] * b64[..., 2] + acc.double()).float()


def _unstrip(six: torch.Tensor) -> torch.Tensor:
    xx, xy, xz, yy, yz, zz = six.unbind(-1)
    r0 = torch.stack([xx, xy, xz], -1)
    r1 = torch.stack([xy, yy, yz], -1)
    r2 = torch.stack([xz, yz, zz], -1)
    return torch.stack([r0, r1, r2], dim=-2)
