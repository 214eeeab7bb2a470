"""The training step and the evaluation render. Port of
`sgs_tpu/train/loop.py` (`TrainState`, `train_step`, `eval_render`).

One `train_step` is render -> (1 - lambda) L1 + lambda (1 - SSIM) ->
gradients of the six parameter fields and of the screen-space tap (Kernel
D, then Kernel C, then autograd through projection and SH) -> the
non-finite guard -> the densification statistics -> masked Adam.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel
from sgs_tpu_torch.ops.ssim import l1_loss, ssim
from sgs_tpu_torch.render.pipeline import render
from sgs_tpu_torch.train.optim import AdamState, adam_update


@dataclass
class TrainState:
    model: GaussianModel
    adam: AdamState
    stats: DensifyStats


def train_step(state: TrainState, camera: Camera, gt_image: torch.Tensor, bg_color: torch.Tensor,
               lrs: Dict[str, float], active_sh_degree: int, lambda_dssim: float = 0.2,
               freeze_xyz: bool = False, apply_update: bool = True,
               mode: str = "tiled") -> Tuple[TrainState, dict]:
    """One optimisation step on one view, rendered by the rasterizer of
    `mode` ("tiled" or "reference"). Returns (new state, metrics): loss,
    l1, n_visible, overflow (always 0: the port sizes its arrays from real
    counts) and nonfinite_grads, all as tensors."""
    model = state.model
    n = model.capacity
    leaves = {f: getattr(model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
    tap = torch.zeros((n, 3), dtype=torch.float32, device=model.device, requires_grad=True)

    out = render(camera, model.with_params(leaves).render_inputs(active_sh_degree), bg_color,
                 vspace_tap=tap, mode=mode)
    image = out["render"]
    ll1 = l1_loss(image, gt_image)
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt_image))
    inputs = [leaves[f] for f in PARAM_FIELDS] + [tap]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]

    # Non-finite guard: a degenerate splat (f32 overflow in the
    # near-singular covariance chain) can poison one backward; its NaNs
    # would reach every alive parameter through Adam within a step. Zero
    # the offending elements and report how many there were.
    with torch.no_grad():
        finite = [torch.isfinite(g) for g in grads]
        nonfinite = sum((~f).sum() for f in finite)
        grads = [torch.where(f, g, 0.0) for f, g in zip(finite, grads)]
        param_grads = dict(zip(PARAM_FIELDS, grads[:-1]))
        tap_grad = grads[-1]
        if freeze_xyz:
            param_grads["xyz"] = torch.zeros_like(param_grads["xyz"])

        new_stats = state.stats.update(tap_grad, out["radii"], out["visibility_filter"])
        if apply_update:
            new_params, new_adam = adam_update(model.params(), param_grads, state.adam, lrs,
                                               update_mask=model.alive)
            new_model = model.with_params(new_params)
        else:
            new_model, new_adam = model, state.adam

    metrics = {
        "loss": loss.detach(),
        "l1": ll1.detach(),
        "n_visible": out["visibility_filter"].sum(),
        "overflow": 0,
        "nonfinite_grads": nonfinite,
    }
    return TrainState(model=new_model, adam=new_adam, stats=new_stats), metrics


@torch.no_grad()
def eval_render(model: GaussianModel, camera: Camera, bg_color: torch.Tensor,
                active_sh_degree: int, mode: str = "reference") -> torch.Tensor:
    """Render one view and clamp to [0, 1]. The default mode is the JAX
    function's, the oracle; "tiled" renders through binning and Kernel A."""
    out = render(camera, model.render_inputs(active_sh_degree), bg_color, mode=mode)
    return torch.clamp(out["render"], 0.0, 1.0)
