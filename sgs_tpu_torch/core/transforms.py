"""Quaternion / covariance geometry. Port of `sgs_tpu/core/transforms.py`.

Quaternions are stored (w, x, y, z), scales are activated (exp applied),
and the 3D covariance Sigma = (R S)(R S)^T is stored as the 6-element upper
triangle [xx, xy, xz, yy, yz, zz]. All functions accept leading batch dims.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    n = torch.linalg.vector_norm(v, dim=dim, keepdim=True)
    if eps:
        n = torch.maximum(n, n.new_tensor(eps))  # jnp.maximum's subgradient
    return v / n


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz quaternion (any norm) -> (..., 3, 3) rotation matrix."""
    q = normalize(q)
    w, x, y, z = q.unbind(-1)
    r0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - w * z), 2.0 * (x * z + w * y)], -1
    )
    r1 = torch.stack(
        [2.0 * (x * y + w * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - w * x)], -1
    )
    r2 = torch.stack(
        [2.0 * (x * z - w * y), 2.0 * (y * z + w * x), 1.0 - 2.0 * (x * x + y * y)], -1
    )
    return torch.stack([r0, r1, r2], dim=-2)


def build_covariance(scales: torch.Tensor, quats: torch.Tensor,
                     scaling_modifier: float = 1.0) -> torch.Tensor:
    """Activated (scale, quat) -> stripped 6-vector covariance, written as
    per-column arithmetic in the same association order as the JAX code."""
    q = normalize(quats)
    w, x, y, z = q.unbind(-1)
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    s = scaling_modifier * scales
    v0 = s[..., 0] * s[..., 0]
    v1 = s[..., 1] * s[..., 1]
    v2 = s[..., 2] * s[..., 2]
    xx = v0 * r00 * r00 + v1 * r01 * r01 + v2 * r02 * r02
    xy = v0 * r00 * r10 + v1 * r01 * r11 + v2 * r02 * r12
    xz = v0 * r00 * r20 + v1 * r01 * r21 + v2 * r02 * r22
    yy = v0 * r10 * r10 + v1 * r11 * r11 + v2 * r12 * r12
    yz = v0 * r10 * r20 + v1 * r11 * r21 + v2 * r12 * r22
    zz = v0 * r20 * r20 + v1 * r21 * r21 + v2 * r22 * r22
    return torch.stack([xx, xy, xz, yy, yz, zz], dim=-1)


def quat_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product of wxyz quaternions, (..., 4) x (..., 4) -> (..., 4),
    in the JAX package's term order (the latent model's composition)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )
