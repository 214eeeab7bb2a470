"""The training step and the evaluation render. Port of
`sgs_tpu/train/loop.py` (`TrainState`, `train_step`, `eval_render`).

One `train_step` is render -> (1 - lambda) L1 + lambda (1 - SSIM) ->
gradients of the six parameter fields and of the screen-space tap (Kernel
D, then Kernel C, then autograd through projection and SH) -> the
non-finite guard -> the densification statistics -> masked Adam. Its
parts (`view_grads`, `zero_nonfinite`, `apply_grads`) are the parallel
steps' too, which reduce over ranks between them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

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


def view_grads(model: GaussianModel, render_fn, gt_image: torch.Tensor, lambda_dssim: float = 0.2,
               tap_cols: int = 3):
    """One view's loss and its gradients. render_fn(leaves, tap) renders
    the model with its six parameter fields replaced by `leaves` and the
    screen-space tap (zeros, (C, tap_cols)) added, and returns a dict with
    "render", "radii" and "visibility_filter". Returns (loss, l1, the
    parameter gradients as a dict, the tap's gradient, render_fn's dict);
    an input the loss does not reach gets zeros."""
    leaves = {f: getattr(model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
    tap = torch.zeros((model.capacity, tap_cols), dtype=torch.float32, device=model.device,
                      requires_grad=True)
    out = render_fn(leaves, tap)
    image = out["render"]
    ll1 = l1_loss(image, gt_image)
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt_image))
    inputs = [leaves[f] for f in PARAM_FIELDS] + [tap]
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]
    return loss.detach(), ll1.detach(), dict(zip(PARAM_FIELDS, grads[:-1])), grads[-1], out


def zero_nonfinite(grads: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, list]:
    """The non-finite guard: (how many elements of `grads` are not finite,
    `grads` with those elements zeroed). A degenerate splat (f32 overflow
    in the near-singular covariance chain) can poison one backward; its
    NaNs would reach every alive parameter through Adam within a step."""
    finite = [torch.isfinite(g) for g in grads]
    count = sum((~f).sum() for f in finite)
    return count, [torch.where(f, g, 0.0) for f, g in zip(finite, grads)]


def apply_grads(state: TrainState, param_grads: Dict[str, torch.Tensor], stats: DensifyStats,
                lrs: Dict[str, float], freeze_xyz: bool = False,
                apply_update: bool = True) -> TrainState:
    """The step's update: xyz's gradient zeroed under freeze_xyz, then
    masked Adam on the alive slots (skipped without apply_update); the new
    state carries `stats`."""
    model = state.model
    if freeze_xyz:
        param_grads = {**param_grads, "xyz": torch.zeros_like(param_grads["xyz"])}
    if not apply_update:
        return TrainState(model=model, adam=state.adam, stats=stats)
    new_params, new_adam = adam_update(model.params(), param_grads, state.adam, lrs,
                                       update_mask=model.alive)
    return TrainState(model=model.with_params(new_params), adam=new_adam, stats=stats)


def train_step(state: TrainState, camera: Camera, gt_image: torch.Tensor, bg_color: torch.Tensor,
               lrs: Dict[str, float], active_sh_degree: int, lambda_dssim: float = 0.2,
               freeze_xyz: bool = False, apply_update: bool = True,
               mode: str = "tiled") -> Tuple[TrainState, dict]:
    """One optimisation step on one view, rendered by the rasterizer of
    `mode` ("tiled", "rect" or "reference"). Returns (new state, metrics): loss,
    l1, n_visible, overflow (always 0: the port sizes its arrays from real
    counts) and nonfinite_grads, all as tensors."""
    model = state.model

    def render_fn(leaves, tap):
        return render(camera, model.with_params(leaves).render_inputs(active_sh_degree), bg_color,
                      vspace_tap=tap, mode=mode)

    loss, ll1, param_grads, tap_grad, out = view_grads(model, render_fn, gt_image, lambda_dssim)
    with torch.no_grad():
        nonfinite, grads = zero_nonfinite(list(param_grads.values()) + [tap_grad])
        param_grads = dict(zip(PARAM_FIELDS, grads[:-1]))
        new_stats = state.stats.update(grads[-1], out["radii"], out["visibility_filter"])
        new_state = apply_grads(state, param_grads, new_stats, lrs, freeze_xyz, apply_update)

    metrics = {
        "loss": loss,
        "l1": ll1,
        "n_visible": out["visibility_filter"].sum(),
        "overflow": 0,
        "nonfinite_grads": nonfinite,
    }
    return new_state, metrics


@torch.no_grad()
def eval_render(model: GaussianModel, camera: Camera, bg_color: torch.Tensor,
                active_sh_degree: int, mode: str = "reference") -> torch.Tensor:
    """Render one view and clamp to [0, 1]. The default mode is the JAX
    function's, the oracle; "tiled" renders through binning and Kernel A."""
    out = render(camera, model.render_inputs(active_sh_degree), bg_color, mode=mode)
    return torch.clamp(out["render"], 0.0, 1.0)
