"""Checkpoints in the JAX package's npz layout. Port of
`sgs_tpu/train/checkpoint.py`.

Keys: param_<field>, adam_mu_<field>, adam_nu_<field>, adam_step_<field>
for the six fields, alive, xyz_gradient_accum, denom, max_radii2d,
iteration, active_sh_degree, max_sh_degree and spatial_lr_scale. A JAX
training state therefore carries across to the port and back.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel
from sgs_tpu_torch.train.loop import TrainState
from sgs_tpu_torch.train.optim import AdamState


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, state: TrainState, iteration: int, active_sh_degree: int,
                    spatial_lr_scale: float) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    for f in PARAM_FIELDS:
        arrays[f"param_{f}"] = _np(getattr(state.model, f))
        arrays[f"adam_mu_{f}"] = _np(state.adam.mu[f])
        arrays[f"adam_nu_{f}"] = _np(state.adam.nu[f])
        arrays[f"adam_step_{f}"] = np.asarray(state.adam.step[f], np.int32)
    arrays["alive"] = _np(state.model.alive)
    arrays["xyz_gradient_accum"] = _np(state.stats.xyz_gradient_accum)
    arrays["denom"] = _np(state.stats.denom)
    arrays["max_radii2d"] = _np(state.stats.max_radii2d)
    arrays["iteration"] = np.asarray(iteration)
    arrays["active_sh_degree"] = np.asarray(active_sh_degree)
    arrays["max_sh_degree"] = np.asarray(state.model.max_sh_degree)
    arrays["spatial_lr_scale"] = np.asarray(spatial_lr_scale)
    np.savez(path, **arrays)


def load_checkpoint(path: str, device: "str | torch.device" = "cuda"
                    ) -> Tuple[TrainState, int, int, float]:
    """Returns (state, iteration, active_sh_degree, spatial_lr_scale)."""
    dev = resolve_device(device)
    z = np.load(path, allow_pickle=False)

    def t(key):
        return torch.as_tensor(np.array(z[key]), device=dev)

    model = GaussianModel(
        **{f: t(f"param_{f}") for f in PARAM_FIELDS},
        alive=t("alive").to(torch.bool),
        max_sh_degree=int(z["max_sh_degree"]),
    )
    adam = AdamState(
        mu={f: t(f"adam_mu_{f}") for f in PARAM_FIELDS},
        nu={f: t(f"adam_nu_{f}") for f in PARAM_FIELDS},
        step={f: int(z[f"adam_step_{f}"]) for f in PARAM_FIELDS},
    )
    stats = DensifyStats(
        xyz_gradient_accum=t("xyz_gradient_accum"), denom=t("denom"), max_radii2d=t("max_radii2d"),
    )
    return (TrainState(model=model, adam=adam, stats=stats), int(z["iteration"]),
            int(z["active_sh_degree"]), float(z["spatial_lr_scale"]))
