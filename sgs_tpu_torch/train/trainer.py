"""Training orchestration. Port of the single-device branch of
`sgs_tpu/train/trainer.py` (`training`, `training_report`).

Per iteration one `train_step` on a view popped at random from a stack of
the train cameras; SH escalation every 1000 iterations; densify/prune in
(densify_from_iter, densify_until_iter) every densification_interval, with
the pool grown first when fewer than 20% of its slots are free; opacity
reset every opacity_reset_interval (and at densify_from_iter on a white
background); no optimizer step on the last iteration; losses.tsv rows,
PLY snapshots and npz checkpoints at the given iterations, and
--start_checkpoint to resume (a JAX checkpoint loads as it is).

The camera order follows the JAX trainer's draws from `random.Random(seed)`:
its instance-bucket sizing samples 4 train cameras at the start and after
every densify step, so the port makes the same `sample` calls (it needs no
bucket) and pops the same views. Random backgrounds and split noise come
from a `torch.Generator` seeded with `seed`.

Not ported, each raising where the JAX trainer would use it: multi-device
training (--parallel dp|hybrid), the rasterizer choices other than the
tiled one and the network viewer. The port does not import tensorboard:
it prints the line the JAX trainer prints when tensorboard is missing
("Tensorboard not available: not logging progress") and trains on.
"""

from __future__ import annotations

import os
import random
import time
from typing import List, Optional

import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.models.densify import densify_and_prune, reset_opacity
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats
from sgs_tpu_torch.ops.ssim import l1_loss, psnr
from sgs_tpu_torch.train import checkpoint as ckpt
from sgs_tpu_torch.train.loop import TrainState, eval_render, train_step
from sgs_tpu_torch.train.optim import AdamState, make_lr_dict
from sgs_tpu_torch.utils.config import (
    ModelParams,
    OptimizationParams,
    PipelineParams,
    check_rasterizer,
    save_cfg_args,
)

GROW_FREE_FRACTION = 0.2
GROW_FACTOR = 2.0
BUCKET_SAMPLE = 4  # cameras the JAX trainer samples to size its buckets
# what `sgs_tpu/train/trainer.py::_make_tb_writer` prints without tensorboard
NO_TENSORBOARD = "Tensorboard not available: not logging progress"


def grow_state(state: TrainState, new_capacity: int) -> TrainState:
    model = state.model.grown(new_capacity)
    extra = new_capacity - state.model.capacity

    def pad(x):
        return torch.cat([x, x.new_zeros((extra,) + tuple(x.shape[1:]))])

    adam = AdamState(
        mu={f: pad(state.adam.mu[f]) for f in PARAM_FIELDS},
        nu={f: pad(state.adam.nu[f]) for f in PARAM_FIELDS},
        step=dict(state.adam.step),
    )
    stats = DensifyStats(
        xyz_gradient_accum=pad(state.stats.xyz_gradient_accum),
        denom=pad(state.stats.denom),
        max_radii2d=pad(state.stats.max_radii2d),
    )
    return TrainState(model=model, adam=adam, stats=stats)


def _check_pipeline(pipe: PipelineParams) -> None:
    if pipe.parallel != "none":
        raise NotImplementedError(
            f"--parallel {pipe.parallel}: multi-device training is not ported yet"
        )
    check_rasterizer(pipe)


def _sample_like_bucket_sizing(py_rng: random.Random, cams: list) -> None:
    if len(cams) > BUCKET_SAMPLE:
        py_rng.sample(cams, BUCKET_SAMPLE)


def training(dataset: ModelParams, opt: OptimizationParams, pipe: PipelineParams,
             testing_iterations: List[int], saving_iterations: List[int],
             checkpoint_iterations: List[int], checkpoint_path: Optional[str] = None,
             scene=None, seed: int = 0, device: "str | torch.device" = "cuda") -> TrainState:
    from sgs_tpu_torch.data.scene import Scene

    _check_pipeline(pipe)
    dev = resolve_device(device)
    if scene is None:
        scene = Scene(dataset, device=dev)
    model_path = dataset.model_path
    os.makedirs(model_path, exist_ok=True)
    save_cfg_args(model_path, dataset)
    tsv = open(os.path.join(model_path, "losses.tsv"), "w")
    tsv.write("iteration\ttest_l1\ttest_psnr\tnum_gaussians\n")
    print(NO_TENSORBOARD)

    model = scene.pool
    state = TrainState(model=model, adam=AdamState.init(model.params()),
                       stats=DensifyStats.zeros(model.capacity, dev))
    spatial_lr_scale = scene.cameras_extent
    active_sh_degree = 0
    first_iter = 0
    if checkpoint_path:
        state, first_iter, active_sh_degree, spatial_lr_scale = ckpt.load_checkpoint(
            checkpoint_path, dev)
        print(f"Restored checkpoint at iteration {first_iter}")

    bg_color = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                            dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    py_rng = random.Random(seed)
    viewpoint_stack: list = []
    train_cams = scene.getTrainCameras()
    print(f"# train cameras {len(train_cams)}")
    print(f"# test cameras {len(scene.getTestCameras())}")
    _sample_like_bucket_sizing(py_rng, train_cams)

    t_start = time.time()
    nonfinite_total = 0
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if iteration % 1000 == 0 and active_sh_degree < dataset.sh_degree:
            active_sh_degree += 1
        if not viewpoint_stack:
            viewpoint_stack = list(train_cams)
        cam = viewpoint_stack.pop(py_rng.randint(0, len(viewpoint_stack) - 1))
        if opt.random_background:
            bg = torch.rand((3,), generator=gen, dtype=torch.float32, device=dev)
        else:
            bg = bg_color
        lrs = make_lr_dict(opt, spatial_lr_scale, iteration)
        state, metrics = train_step(
            state, cam.camera, cam.gt_image, bg, lrs, active_sh_degree=active_sh_degree,
            lambda_dssim=opt.lambda_dssim, freeze_xyz=dataset.freeze_xyz,
            apply_update=iteration < opt.iterations,
        )
        nfg = int(metrics["nonfinite_grads"])
        nonfinite_total += nfg
        if nfg:
            print(f"\n[ITER {iteration}] WARNING: {nfg} non-finite gradient elements zeroed "
                  "this step (degenerate splat geometry)")

        if iteration in testing_iterations:
            training_report(tsv, iteration, scene, state.model, active_sh_degree, bg_color)
        if iteration in saving_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.save(state.model, iteration)

        if iteration < opt.densify_until_iter:
            if iteration > opt.densify_from_iter and iteration % opt.densification_interval == 0:
                cap = state.model.capacity
                if cap - state.model.num_alive < GROW_FREE_FRACTION * cap:
                    new_cap = int(-(-cap * GROW_FACTOR // 256) * 256)
                    print(f"\n[ITER {iteration}] Growing pool {cap} -> {new_cap}")
                    state = grow_state(state, new_cap)
                size_threshold = 20.0 if iteration > opt.opacity_reset_interval else 0.0
                new_model, new_adam, new_stats, info = densify_and_prune(
                    state.model, state.adam, state.stats,
                    max_grad=opt.densify_grad_threshold, min_opacity=0.005,
                    extent=scene.cameras_extent, max_screen_size=size_threshold,
                    percent_dense=opt.percent_dense, generator=gen,
                )
                state = TrainState(model=new_model, adam=new_adam, stats=new_stats)
                print(f"\n[ITER {iteration}] densify: {info['n_cloned']} cloned, "
                      f"{info['n_split']} split, {info['n_pruned']} pruned, "
                      f"{info['num_alive']} alive")
                if info["n_dropped_overflow"]:
                    print(f"\n[ITER {iteration}] WARNING: dropped {info['n_dropped_overflow']} "
                          "densified Gaussians (pool full)")
                _sample_like_bucket_sizing(py_rng, train_cams)
            if iteration % opt.opacity_reset_interval == 0 or (
                dataset.white_background and iteration == opt.densify_from_iter
            ):
                new_model, new_adam = reset_opacity(state.model, state.adam)
                state = TrainState(model=new_model, adam=new_adam, stats=state.stats)

        if iteration in checkpoint_iterations:
            print(f"\n[ITER {iteration}] Saving Checkpoint")
            ckpt.save_checkpoint(os.path.join(model_path, f"chkpnt{iteration}.npz"), state,
                                 iteration, active_sh_degree, spatial_lr_scale)

    tsv.close()
    elapsed = time.time() - t_start
    iters = opt.iterations - first_iter
    if iters > 0:
        print(f"\nTrained {iters} iterations in {elapsed:.1f}s ({iters / elapsed:.2f} it/s)")
        print(f"nonfinite_grads: {nonfinite_total} elements zeroed over {iters} steps")
    return state


def training_report(tsv, iteration: int, scene, model, active_sh_degree: int,
                    bg_color: torch.Tensor) -> None:
    """Mean L1 and PSNR over the test views and over train views 5..29;
    the test numbers become a losses.tsv row."""
    train_cams = scene.getTrainCameras()
    train_eval = [train_cams[i % len(train_cams)] for i in range(5, 30)] if train_cams else []
    n_gaussians = model.num_alive
    for name, cams in (("test", scene.getTestCameras()), ("train", train_eval)):
        if not cams:
            continue
        l1_sum, psnr_sum = 0.0, 0.0
        for cam in cams:
            image = eval_render(model, cam.camera, bg_color, active_sh_degree)
            gt = torch.clamp(cam.gt_image, 0.0, 1.0)
            l1_sum += float(l1_loss(image, gt))
            psnr_sum += float(psnr(image, gt))
        l1_avg, psnr_avg = l1_sum / len(cams), psnr_sum / len(cams)
        print(f"\n[ITER {iteration}] Evaluating {name}: L1 {l1_avg} PSNR {psnr_avg}")
        print(f"# of Gaussians: {n_gaussians}")
        if name == "test" and tsv is not None:
            tsv.write(f"{iteration}\t{l1_avg}\t{psnr_avg}\t{n_gaussians}\n")
            tsv.flush()
