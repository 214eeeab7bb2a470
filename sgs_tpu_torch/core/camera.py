"""Render camera. Port of `sgs_tpu/core/camera.py`.

Matrices keep the transposed (row-vector) convention: `world_view_transform`
and `full_proj_transform` are applied as `p_hom @ M`. They are built in
numpy exactly as the JAX camera builds them, then moved to the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
import numpy as np
import torch

from sgs_tpu_torch.core import projection
from sgs_tpu_torch.core.device import resolve_device

ZNEAR, ZFAR = 0.01, 100.0


@dataclass
class Camera:
    world_view_transform: torch.Tensor  # (4, 4) transposed world->view
    full_proj_transform: torch.Tensor  # (4, 4) transposed world->clip
    camera_center: torch.Tensor  # (3,)
    tanfovx: torch.Tensor  # 0-d f32
    tanfovy: torch.Tensor  # 0-d f32
    image_width: int
    image_height: int

    @classmethod
    def from_Rt(
        cls,
        R: np.ndarray,
        T: np.ndarray,
        fovx: float,
        fovy: float,
        width: int,
        height: int,
        device: "str | torch.device" = "cuda",
    ) -> "Camera":
        """Build from COLMAP-style (R camera-to-world, T world-to-view)."""
        w2v = projection.world_to_view(R, T)
        proj = projection.perspective_projection(ZNEAR, ZFAR, fovx, fovy)
        view_T = w2v.T
        full_T = (proj @ w2v).T
        center = np.linalg.inv(view_T)[3, :3]
        device = resolve_device(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        return cls(
            world_view_transform=f32(view_T),
            full_proj_transform=f32(full_T),
            camera_center=f32(center),
            tanfovx=f32(math.tan(fovx * 0.5)),
            tanfovy=f32(math.tan(fovy * 0.5)),
            image_width=int(width),
            image_height=int(height),
        )

    @classmethod
    def from_matrices(
        cls,
        world_view_transform: np.ndarray,
        full_proj_transform: np.ndarray,
        fovx: float,
        fovy: float,
        width: int,
        height: int,
        device: "str | torch.device" = "cuda",
    ) -> "Camera":
        """A pose-only camera from transposed matrices, as the network viewer
        sends them: the centre is the inverse of the view matrix, all in f32."""
        view_T = np.asarray(world_view_transform, dtype=np.float32)
        center = np.linalg.inv(view_T)[3, :3]
        device = resolve_device(device)

        def f32(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

        return cls(
            world_view_transform=f32(view_T),
            full_proj_transform=f32(full_proj_transform),
            camera_center=f32(center),
            tanfovx=f32(math.tan(fovx * 0.5)),
            tanfovy=f32(math.tan(fovy * 0.5)),
            image_width=int(width),
            image_height=int(height),
        )
