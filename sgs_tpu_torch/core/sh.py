"""Real spherical harmonics, degrees 0-4. Port of `sgs_tpu/core/sh.py`.

SH coefficients are stored `(..., K, 3)`: K = (deg+1)^2 coefficient vectors
of RGB, the concatenation of `features_dc` (N,1,3) and `features_rest`
(N,K-1,3).
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit directions -> (..., (degree+1)^2) basis values."""
    if not (0 <= degree <= 4):
        raise ValueError(f"SH degree must be in [0, 4], got {degree}")
    ones = torch.ones_like(dirs[..., 0])
    out = [C0 * ones]
    if degree >= 1:
        x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3.0 * xx - yy),
            C4[2] * xy * (7.0 * zz - 1.0),
            C4[3] * yz * (7.0 * zz - 3.0),
            C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            C4[5] * xz * (7.0 * zz - 3.0),
            C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            C4[7] * xz * (xx - 3.0 * yy),
            C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(degree: int, sh_coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH -> RGB. sh_coeffs (..., K, 3) with K >= (degree+1)^2; dirs (..., 3).
    Only the first (degree+1)^2 coefficients contribute."""
    k = num_sh_coeffs(degree)
    basis = sh_basis(degree, dirs)
    return (basis[..., None] * sh_coeffs[..., :k, :]).sum(-2)


def sh_to_rgb_clamped(degree: int, sh_coeffs: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The rasterizer's SH->color path: +0.5 offset then clamp at 0. The
    gradient is zero where the colour is clamped, and split in half at an
    exact tie, as `jnp.maximum`'s is."""
    rgb = eval_sh(degree, sh_coeffs, dirs) + 0.5
    return torch.maximum(rgb, torch.zeros_like(rgb))


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """Inverse DC mapping (RGB2SH)."""
    return (rgb - 0.5) / C0
