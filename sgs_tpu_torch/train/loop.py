"""Evaluation render. Port of `eval_render` in `sgs_tpu/train/loop.py`."""

from __future__ import annotations

import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.render.pipeline import render


@torch.no_grad()
def eval_render(model: GaussianModel, camera: Camera, bg_color: torch.Tensor,
                active_sh_degree: int) -> torch.Tensor:
    """Render one view through the tiled path and clamp to [0, 1]."""
    out = render(camera, model.render_inputs(active_sh_degree), bg_color)
    return torch.clamp(out["render"], 0.0, 1.0)
