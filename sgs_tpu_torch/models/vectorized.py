"""Vectorize / PCA analysis of a Gaussian set. Port of
`sgs_tpu/models/vectorized.py`.

`vectorized` flattens a model's alive rows into (N, 11) shape parameters
[xyz, activated opacity, activated scale, normalised rotation] and (N, 3K)
appearance parameters (raw SH, channel-major); `from_vector` inverts it,
re-applying the inverse activations; `pca_project` is the low-rank
reconstruction of the appearance parameters. The arithmetic is the JAX
module's numpy, so both packages give the same bits from the same arrays.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sgs_tpu_torch.models.gaussians import GaussianModel, from_jax_arrays


def vectorized(model: GaussianModel) -> Tuple[np.ndarray, np.ndarray]:
    """Model -> (shape_params (N, 11), appearance_params (N, 3K)), the
    alive rows in slot order."""
    arrays = model.compact_arrays()
    xyz = arrays["xyz"]
    opac = 1.0 / (1.0 + np.exp(-arrays["opacity"]))
    scale = np.exp(arrays["scaling"])
    rot = arrays["rotation"]
    rot = rot / np.linalg.norm(rot, axis=-1, keepdims=True)
    n = xyz.shape[0]
    f_dc = np.transpose(arrays["features_dc"], (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(arrays["features_rest"], (0, 2, 1)).reshape(n, -1)
    shape_params = np.concatenate([xyz, opac, scale, rot], axis=1)
    appearance_params = np.concatenate([f_dc, f_rest], axis=1)
    return shape_params.astype(np.float32), appearance_params.astype(np.float32)


def from_vector(sh_degree: int, shape_params: np.ndarray, appearance_params: np.ndarray,
                device: "str | torch.device" = "cuda") -> GaussianModel:
    """Inverse of `vectorized`; every row alive."""
    n = shape_params.shape[0]
    xyz = shape_params[:, 0:3]
    opac = shape_params[:, 3:4]
    scale = shape_params[:, 4:7]
    rot = shape_params[:, 7:11]
    k = (sh_degree + 1) ** 2
    f_dc = appearance_params[:, :3].reshape(n, 3, 1).transpose(0, 2, 1)
    f_rest = appearance_params[:, 3:].reshape(n, 3, k - 1).transpose(0, 2, 1)
    eps = 1e-12
    clipped = np.clip(opac, eps, 1 - eps)
    arrays = {
        "xyz": xyz,
        "features_dc": f_dc,
        "features_rest": f_rest,
        "opacity": np.log(clipped / (1 - clipped)),
        "scaling": np.log(np.maximum(scale, eps)),
        "rotation": rot,
    }
    return from_jax_arrays({f: v.astype(np.float32) for f, v in arrays.items()}, sh_degree, device)


def compute_normalization(appearance_params: np.ndarray):
    return appearance_params.mean(axis=0), appearance_params.std(axis=0)


def pca_project(appearance_params: np.ndarray, rank: int, mean: Optional[np.ndarray] = None,
                std: Optional[np.ndarray] = None):
    """Rank-`rank` PCA reconstruction of the appearance parameters (float64
    eigen-decomposition of the covariance) and the variance-explained
    spectrum. The reconstruction x q q^T does not depend on the signs of
    the eigenvectors."""
    x = appearance_params.astype(np.float64)
    mean = x.mean(axis=0) if mean is None else mean
    x = x - mean[None, :]
    if std is not None:
        std = np.maximum(std, 1e-12)  # constant dims (zero SH bands)
        x = x / std[None, :]
    evals, evecs = np.linalg.eigh(x.T @ x)
    order = np.argsort(evals)[::-1]
    evals, evecs = evals[order], evecs[:, order]
    ratio = evals / evals.sum()
    q = evecs[:, :rank]
    recon = x @ q @ q.T
    if std is not None:
        recon = recon * std[None, :]
    recon = recon + mean[None, :]
    return recon.astype(np.float32), ratio
