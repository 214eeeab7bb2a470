"""Capacity-padded Gaussian pool and densification statistics. Port of
`sgs_tpu/models/gaussians.py` (`GaussianPool`, `DensifyStats`).

Raw parameters follow the reference parameterisation: xyz, features_dc
(C,1,3), features_rest (C,K-1,3), log-scales, wxyz quaternions and opacity
logits, plus an `alive` mask. The port keeps the JAX pool's slot layout:
a capacity C, dead slots holding benign values, children of a densify
step placed into free slots and growth by appending dead slots. A densify
result and a checkpoint therefore compare with the JAX package's slot by
slot. The parameter tensors are plain tensors; the train step makes leaf
copies with requires_grad for each backward.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from sgs_tpu_torch.core import sh as sh_lib
from sgs_tpu_torch.core import transforms
from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.data.ply import load_gaussian_ply

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
DEAD_OPACITY_LOGIT = -10.0
DEAD_LOG_SCALE = -10.0


@dataclass
class GaussianInputs:
    """Activated per-Gaussian attributes handed to the rasterizer, with the
    alternatives the CUDA rasterizer accepts: one of {scales + rotations,
    cov3d_precomp} and one of {shs, colors_precomp}."""

    means3d: torch.Tensor  # (N, 3)
    opacities: torch.Tensor  # (N, 1) sigmoid applied
    scales: Optional[torch.Tensor] = None  # (N, 3) exp applied
    rotations: Optional[torch.Tensor] = None  # (N, 4) unit-normalised wxyz
    cov3d_precomp: Optional[torch.Tensor] = None  # (N, 6)
    shs: Optional[torch.Tensor] = None  # (N, K, 3)
    colors_precomp: Optional[torch.Tensor] = None  # (N, 3)
    sh_degree: int = 0
    alive: Optional[torch.Tensor] = None  # (N,) bool; None: every row


@dataclass
class GaussianModel:
    xyz: torch.Tensor
    features_dc: torch.Tensor
    features_rest: torch.Tensor
    scaling: torch.Tensor
    rotation: torch.Tensor
    opacity: torch.Tensor
    alive: torch.Tensor  # (N,) bool
    max_sh_degree: int = 3

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def params(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in PARAM_FIELDS}

    def with_params(self, params: Dict[str, torch.Tensor]) -> "GaussianModel":
        return dataclasses.replace(self, **params)

    @property
    def get_scaling(self) -> torch.Tensor:
        return torch.exp(self.scaling)

    @property
    def get_rotation(self) -> torch.Tensor:
        return transforms.normalize(self.rotation, eps=1e-12)

    @property
    def get_opacity(self) -> torch.Tensor:
        return torch.sigmoid(self.opacity)

    @property
    def get_features(self) -> torch.Tensor:
        return torch.cat([self.features_dc, self.features_rest], dim=1)

    def render_inputs(self, active_sh_degree: int) -> GaussianInputs:
        """Bundle activated attributes for the rasterizer."""
        return GaussianInputs(
            means3d=self.xyz,
            opacities=self.get_opacity,
            scales=self.get_scaling,
            rotations=self.get_rotation,
            shs=self.get_features,
            sh_degree=active_sh_degree,
            alive=self.alive,
        )

    @classmethod
    def from_ply(cls, path: str, max_sh_degree: int = 3,
                 device: "str | torch.device" = "cuda") -> "GaussianModel":
        return from_jax_arrays(load_gaussian_ply(path, max_sh_degree), max_sh_degree, device)

    @classmethod
    def empty(cls, capacity: int, max_sh_degree: int = 3,
              device: "str | torch.device" = "cuda") -> "GaussianModel":
        """All slots dead, holding the benign values (identity rotation,
        tiny scale, -10 opacity logit)."""
        dev = resolve_device(device)
        k = sh_lib.num_sh_coeffs(max_sh_degree)
        f32 = dict(dtype=torch.float32, device=dev)
        rotation = torch.zeros((capacity, 4), **f32)
        rotation[:, 0] = 1.0
        return cls(
            xyz=torch.zeros((capacity, 3), **f32),
            features_dc=torch.zeros((capacity, 1, 3), **f32),
            features_rest=torch.zeros((capacity, k - 1, 3), **f32),
            scaling=torch.full((capacity, 3), DEAD_LOG_SCALE, **f32),
            rotation=rotation,
            opacity=torch.full((capacity, 1), DEAD_OPACITY_LOGIT, **f32),
            alive=torch.zeros((capacity,), dtype=torch.bool, device=dev),
            max_sh_degree=max_sh_degree,
        )

    @classmethod
    def from_pcd(cls, points: np.ndarray, colors: np.ndarray, max_sh_degree: int = 3,
                 capacity: Optional[int] = None, knn_dist2: Optional[np.ndarray] = None,
                 device: "str | torch.device" = "cuda") -> "GaussianModel":
        """SfM points -> pool (create_from_pcd): isotropic log-scale
        0.5 log(mean squared distance to the 3 nearest neighbours, at least
        1e-7), identity rotations, opacity logit of 0.1, DC colour
        RGB2SH(rgb), in slots [0, n)."""
        from sgs_tpu_torch.ops.knn import mean_sq_dist_3nn

        n = points.shape[0]
        capacity = int(capacity or default_capacity(n))
        if capacity < n:
            raise ValueError(f"capacity {capacity} < initial points {n}")
        pool = cls.empty(capacity, max_sh_degree, device)
        dev = pool.device
        pts = torch.as_tensor(np.asarray(points, np.float32), device=dev)
        dist2 = mean_sq_dist_3nn(pts) if knn_dist2 is None else torch.as_tensor(
            np.asarray(knn_dist2, np.float32), device=dev)
        dist2 = torch.maximum(dist2, dist2.new_tensor(1e-7))
        log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
        dc = sh_lib.rgb_to_sh(torch.as_tensor(np.asarray(colors, np.float32), device=dev))[:, None, :]
        opac = transforms.inverse_sigmoid(0.1 * torch.ones((n, 1), dtype=torch.float32, device=dev))
        pool.xyz[:n] = pts
        pool.features_dc[:n] = dc
        pool.scaling[:n] = log_scale
        pool.opacity[:n] = opac
        pool.alive[:n] = True
        return pool

    def grown(self, new_capacity: int) -> "GaussianModel":
        """Capacity growth: dead slots appended at the end."""
        if new_capacity < self.capacity:
            raise ValueError("cannot shrink pool")
        if new_capacity == self.capacity:
            return self
        tail = GaussianModel.empty(new_capacity - self.capacity, self.max_sh_degree, self.device)
        return GaussianModel(
            **{f: torch.cat([getattr(self, f), getattr(tail, f)]) for f in PARAM_FIELDS},
            alive=torch.cat([self.alive, tail.alive]),
            max_sh_degree=self.max_sh_degree,
        )

    def compact_arrays(self) -> Dict[str, np.ndarray]:
        """The alive rows as numpy arrays, in slot order (for PLY export)."""
        idx = torch.nonzero(self.alive).flatten()
        return {f: getattr(self, f)[idx].detach().cpu().numpy() for f in PARAM_FIELDS}


def default_capacity(n: int) -> int:
    """Initial capacity: room to densify before the first growth, rounded
    up to a multiple of 256 (the JAX pool's rule, kept so slots match)."""
    c = max(int(n * 1.5), n + 1024)
    return -(-c // 256) * 256


@dataclass
class DensifyStats:
    """Densification accumulators: summed screen-space gradient norms,
    view counts and the largest screen radius of each slot."""

    xyz_gradient_accum: torch.Tensor  # (C, 1)
    denom: torch.Tensor  # (C, 1)
    max_radii2d: torch.Tensor  # (C,)

    @classmethod
    def zeros(cls, capacity: int, device: "str | torch.device" = "cuda") -> "DensifyStats":
        dev = torch.device(device)
        return cls(
            xyz_gradient_accum=torch.zeros((capacity, 1), dtype=torch.float32, device=dev),
            denom=torch.zeros((capacity, 1), dtype=torch.float32, device=dev),
            max_radii2d=torch.zeros((capacity,), dtype=torch.float32, device=dev),
        )

    def update(self, vspace_grad: torch.Tensor, radii: torch.Tensor,
               visibility: torch.Tensor) -> "DensifyStats":
        """Accumulate ||dL/d mean2D_xy|| and the radius of visible slots."""
        gnorm = torch.linalg.vector_norm(vspace_grad[:, :2], dim=-1, keepdim=True)
        vis = visibility[:, None]
        return DensifyStats(
            xyz_gradient_accum=self.xyz_gradient_accum + torch.where(vis, gnorm, 0.0),
            denom=self.denom + vis.to(torch.float32),
            max_radii2d=torch.maximum(
                self.max_radii2d, torch.where(visibility, radii.to(torch.float32), 0.0)
            ),
        )

    def merge(self, other: "DensifyStats") -> "DensifyStats":
        """The statistics of two sets of views: sums added, radii maxed."""
        return DensifyStats(
            xyz_gradient_accum=self.xyz_gradient_accum + other.xyz_gradient_accum,
            denom=self.denom + other.denom,
            max_radii2d=torch.maximum(self.max_radii2d, other.max_radii2d),
        )


def from_jax_arrays(arrays: Dict[str, np.ndarray], max_sh_degree: int = 3,
                    device: "str | torch.device" = "cuda") -> GaussianModel:
    """Carry the fields of a JAX `GaussianPool` (as numpy arrays: xyz,
    features_dc, features_rest, scaling, rotation, opacity and the optional
    alive mask) across, so both packages compute from the same parameters.
    Without `alive` (a PLY snapshot) every Gaussian is alive."""
    dev = resolve_device(device)
    fields = {
        f: torch.as_tensor(np.array(arrays[f], np.float32), device=dev) for f in PARAM_FIELDS
    }
    n = fields["xyz"].shape[0]
    alive = arrays.get("alive")
    alive = (
        torch.ones(n, dtype=torch.bool, device=dev) if alive is None
        else torch.as_tensor(np.array(alive, bool), device=dev)
    )
    return GaussianModel(**fields, alive=alive, max_sh_degree=max_sh_degree)
