"""Latent/structured training: the train_lgm loop. Port of
`sgs_tpu/train/lgm_trainer.py` (`make_lgm_train_step`, the LGM
checkpoint, `training_lgm`, `report_lgm`).

SH degree 0 only; the model is decoded again in every step before the
render, so the gradient flows through the decoder into the latents and
the structure parameters; no densification and no learning-rate
schedule; one `optax.adam(5e-4, eps=1e-15)` over every leaf
(`optim.adam_tree_update`). A step is decode -> render -> (1 - lambda) L1
+ lambda (1 - SSIM) -> the gradient of every leaf (Kernels D and C, then
autograd through projection, SH, the composition and the decoder) ->
non-finite elements zeroed -> Adam. Views are popped from a stack of the
train cameras with `random.Random(seed).randint`, as the JAX trainer
pops them: it sizes its buckets from the first train camera, so, unlike
the 3DGS trainer, it makes no `sample` calls for them. Random
backgrounds and the random parts of the init come from a
`torch.Generator` seeded with `seed`.

The checkpoint is JAX's npz (`iteration` and `p:<path>` for each leaf,
decoder kernels in JAX's (in, out) layout), so each package loads the
other's. Resuming restores the parameters only: Adam starts afresh, as
`optax.adam` does in the JAX trainer.

The JAX trainer's instance buckets (`compute_buckets`, the overflow
regrow and the warm-up shrink re-bucket) are not ported: the port sizes
every array from the real counts (`render/pipeline.py`), so nothing can
overflow and nothing needs re-sizing, and the bucket lines are not
printed. Each iteration first serves the network viewer
(`viewer/network_gui.serve`, a no-op unless a listener was started),
rendering the decoded model with the pipeline's rasterizer at the
client's scaling modifier, clamped to [0, 1].
"""

from __future__ import annotations

import os
import random
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.data import ply as ply_io
from sgs_tpu_torch.models.latent import LatentGaussianModel
from sgs_tpu_torch.ops.ssim import l1_loss, psnr, ssim
from sgs_tpu_torch.render.pipeline import render
from sgs_tpu_torch.train.optim import TreeAdamState, adam_tree_update
from sgs_tpu_torch.utils.config import (
    ModelParams,
    OptimizationParams,
    PipelineParams,
    check_rasterizer,
    save_cfg_args,
)
from sgs_tpu_torch.viewer import network_gui

LGM_LR = 1.0e-3 / 2
LGM_EPS = 1e-15


def lgm_grads(model: LatentGaussianModel, camera: Camera, gt_image: torch.Tensor,
              bg: torch.Tensor, lambda_dssim: float, active_sh_degree: int, mode: str = "tiled"
              ) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor], dict]:
    """The step's loss, L1, the gradient of every leaf of
    `model.trainable_params()` (before the non-finite guard) and the
    render's output, rendered by the rasterizer of `mode`."""
    params = model.trainable_params()
    out = render(camera, model.render_inputs(active_sh_degree), bg, mode=mode)
    image = out["render"]
    ll1 = l1_loss(image, gt_image)
    loss = (1.0 - lambda_dssim) * ll1 + lambda_dssim * (1.0 - ssim(image, gt_image))
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(params.items(), grads)}
    return loss.detach(), ll1.detach(), grads, out


def lgm_train_step(model: LatentGaussianModel, adam: TreeAdamState, camera: Camera,
                   gt_image: torch.Tensor, bg: torch.Tensor, lambda_dssim: float,
                   active_sh_degree: int, mode: str = "tiled") -> Tuple[TreeAdamState, dict]:
    """One optimisation step; updates the model's parameters in place and
    returns (new Adam state, metrics: loss, l1, nonfinite_grads)."""
    loss, ll1, grads, _ = lgm_grads(model, camera, gt_image, bg, lambda_dssim, active_sh_degree,
                                    mode)
    with torch.no_grad():
        finite = {k: torch.isfinite(g) for k, g in grads.items()}
        nonfinite = sum((~f).sum() for f in finite.values())
        grads = {k: torch.where(finite[k], g, 0.0) for k, g in grads.items()}
        params = model.trainable_params()
        new_params, adam = adam_tree_update(params, grads, adam, LGM_LR, eps=LGM_EPS)
        for k, p in params.items():
            p.copy_(new_params[k])
    return adam, {"loss": loss, "l1": ll1, "nonfinite_grads": nonfinite}


def save_lgm_checkpoint(path: str, model: LatentGaussianModel, iteration: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {"iteration": np.asarray(iteration)}
    arrays.update({f"p:{k}": v for k, v in model.jax_arrays().items()})
    np.savez(path, **arrays)


def load_lgm_checkpoint(path: str, model: LatentGaussianModel) -> Tuple[LatentGaussianModel, int]:
    """Load the parameters into `model` (its configuration must match the
    checkpoint's); returns (model, iteration)."""
    z = np.load(path, allow_pickle=False)
    model.load_jax_arrays({k: z[f"p:{k}"] for k in model.trainable_params()})
    return model, int(z["iteration"])


def training_lgm(dataset: ModelParams, opt: OptimizationParams, pipe: PipelineParams,
                 testing_iterations: List[int], saving_iterations: List[int],
                 checkpoint_iterations: List[int], checkpoint_path: Optional[str] = None,
                 scene=None, seed: int = 0, latent_size: int = 32, hidden_size: int = 32,
                 gaussians_per_structure: int = 8, use_positional_embedding: bool = False,
                 downsample_init: float = 1.0,
                 device: "str | torch.device" = "cuda") -> LatentGaussianModel:
    from sgs_tpu_torch.data.scene import Scene

    if dataset.sh_degree != 0:
        raise ValueError("train_lgm requires sh_degree == 0")
    mode = check_rasterizer(pipe)
    dev = resolve_device(device)
    model_path = dataset.model_path
    os.makedirs(model_path, exist_ok=True)
    save_cfg_args(model_path, dataset)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    py_rng = random.Random(seed)
    if scene is None:
        scene = Scene(dataset, downsample_init=downsample_init, device=dev)
    pcd = scene.init_pcd
    model = LatentGaussianModel.create(
        gen, np.zeros((1, 3), np.float32), device=dev, sh_degree=dataset.sh_degree,
        latent_size=latent_size, hidden_size=hidden_size,
        gaussians_per_structure=gaussians_per_structure,
        use_positional_embedding=use_positional_embedding,
    )
    model.create_from_pcd(gen, pcd.points, pcd.colors)
    print(f"Number of structures at initialisation : {model.num_structures}")

    first_iter = 0
    if checkpoint_path:
        model, first_iter = load_lgm_checkpoint(checkpoint_path, model)
        print(f"Restored LGM checkpoint at iteration {first_iter}")
    adam = TreeAdamState.init(model.trainable_params())
    active_sh_degree = dataset.sh_degree
    bg_color = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                            dtype=torch.float32, device=dev)

    train_cams = scene.getTrainCameras()
    viewpoint_stack: list = []
    ema_loss = 0.0
    t0 = time.time()
    for iteration in range(first_iter + 1, opt.iterations + 1):
        network_gui.serve(
            lambda cam, sm: torch.clamp(render(cam, model.render_inputs(active_sh_degree), bg_color,
                                               scaling_modifier=sm, mode=mode)["render"],
                                        0.0, 1.0),
            dataset.source_path, iteration, opt.iterations, dev,
        )
        if not viewpoint_stack:
            viewpoint_stack = list(train_cams)
        cam = viewpoint_stack.pop(py_rng.randint(0, len(viewpoint_stack) - 1))
        if opt.random_background:
            bg = torch.rand((3,), generator=gen, dtype=torch.float32, device=dev)
        else:
            bg = bg_color

        adam, metrics = lgm_train_step(model, adam, cam.camera, cam.gt_image, bg,
                                       opt.lambda_dssim, active_sh_degree, mode)
        ema_loss = 0.4 * float(metrics["loss"]) + 0.6 * ema_loss
        if not pipe.no_tqdm and iteration % 100 == 0:
            print(f"[{iteration}] ema loss {ema_loss:.6f}")

        if iteration in testing_iterations:
            report_lgm(iteration, scene, model, active_sh_degree, bg_color, mode)
        if iteration in saving_iterations:
            path = os.path.join(model_path, f"point_cloud/iteration_{iteration}", "point_cloud.ply")
            with torch.no_grad():
                raw = {k: v.cpu().numpy() for k, v in model.decode().items()}
            ply_io.save_gaussian_ply(path, raw["xyz"], raw["features_dc"], raw["features_rest"],
                                     raw["opacity"], raw["scaling"], raw["rotation"])
            print(f"\n[ITER {iteration}] Saved Gaussians to {path}")
        if iteration in checkpoint_iterations:
            save_lgm_checkpoint(os.path.join(model_path, f"chkpnt{iteration}.npz"), model, iteration)
            print(f"\n[ITER {iteration}] Saved Checkpoint")

    elapsed = time.time() - t0
    n_iters = opt.iterations - first_iter
    if n_iters > 0:
        print(f"\nLGM: {n_iters} iters in {elapsed:.1f}s ({n_iters / elapsed:.2f} it/s)")
    return model


@torch.no_grad()
def report_lgm(iteration: int, scene, model: LatentGaussianModel, active_sh_degree: int,
               bg_color: torch.Tensor, mode: str = "tiled") -> None:
    """Prints the mean L1 and PSNR over the test views and the first 8
    train views, rendered by the rasterizer of `mode`, as the JAX trainer
    does."""
    for name, cams in (("test", scene.getTestCameras()), ("train", scene.getTrainCameras()[:8])):
        if not cams:
            continue
        inputs = model.render_inputs(active_sh_degree)
        l1s, psnrs = [], []
        for cam in cams:
            img = torch.clamp(render(cam.camera, inputs, bg_color, mode=mode)["render"], 0.0, 1.0)
            gt = torch.clamp(cam.gt_image, 0.0, 1.0)
            l1s.append(float(l1_loss(img, gt)))
            psnrs.append(float(psnr(img, gt)))
        print(f"\n[ITER {iteration}] Evaluating {name}: L1 {np.mean(l1s)} PSNR {np.mean(psnrs)}")
