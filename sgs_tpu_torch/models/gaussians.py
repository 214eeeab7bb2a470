"""Gaussian model parameters and their activations. Port of the parameter
and activation half of `sgs_tpu/models/gaussians.py` (`GaussianPool`).

Raw parameters follow the reference parameterisation: xyz, features_dc
(N,1,3), features_rest (N,K-1,3), log-scales, wxyz quaternions and opacity
logits, plus an `alive` mask so a padded JAX pool carries across as is.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from sgs_tpu_torch.core import transforms
from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.data.ply import load_gaussian_ply

PARAM_FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")


@dataclass
class GaussianInputs:
    """Activated per-Gaussian attributes handed to the rasterizer."""

    means3d: torch.Tensor  # (N, 3)
    opacities: torch.Tensor  # (N, 1) sigmoid applied
    scales: torch.Tensor  # (N, 3) exp applied
    rotations: torch.Tensor  # (N, 4) unit-normalised wxyz
    shs: torch.Tensor  # (N, K, 3)
    sh_degree: int
    alive: torch.Tensor  # (N,) bool


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
