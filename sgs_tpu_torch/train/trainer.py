"""Training orchestration. Port of `sgs_tpu/train/trainer.py` (`training`,
`training_report`).

Per iteration one `train_step` on a view popped at random from a stack of
the train cameras; SH escalation every 1000 iterations; densify/prune in
(densify_from_iter, densify_until_iter) every densification_interval, with
the pool grown first when fewer than 20% of its slots are free; opacity
reset every opacity_reset_interval (and at densify_from_iter on a white
background); no optimizer step on the last iteration; losses.tsv rows,
PLY snapshots and npz checkpoints at the given iterations, and
--start_checkpoint to resume (a JAX checkpoint loads as it is).

The camera order follows the JAX trainer's draws from `random.Random(seed)`:
with the tiled rasterizer its instance-bucket sizing samples 4 train
cameras at the start and after every densify step, so the port makes the
same `sample` calls (it needs no bucket) and pops the same views. Random backgrounds and split noise come
from a `torch.Generator` seeded with `seed`.

`--rasterizer reference` trains and reports through the O(N*P) oracle,
its backward by autograd, as the JAX trainer does. Each iteration first
serves the network viewer (`viewer/network_gui.serve`, a no-op unless a
listener was started), rendering through `eval_render` with the
pipeline's rasterizer (Kernel A on the card).

Multi-device training (`--parallel dp|hybrid`, `parallel/`) runs one
process a rank under torchrun (`init_distributed`: NCCL on the card,
gloo on the CPU). Every rank draws the same `py_rng` sequence and pops
the step's batch of one camera a data rank, and trains camera
`data_rank` of it; in hybrid the band sizing's `sample` calls are made at
the first step and after each densify, as JAX makes them. dp keeps the
whole state on every rank (broadcast from rank 0 after each densify);
hybrid keeps each rank's gauss slice and gathers the full state for
densify/prune (the same generator on every rank, then each rank keeps its
slice), the test report, the PLYs and the checkpoints. Rank 0 alone
writes losses.tsv, cfg_args, the PLYs and the checkpoints. The viewer is
served by rank 0 in dp and not in hybrid (its state is sliced).

`--no-tight_culling` bins each Gaussian's whole rect (JAX's rect binning:
the same pixels from more instances). Not ported, raising where the JAX
trainer would use it: hybrid training without tight culling. The port does
not import tensorboard: it prints the line the JAX trainer prints when
tensorboard is missing ("Tensorboard not available: not logging
progress") and trains on.
"""

from __future__ import annotations

import os
import random
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.models.densify import densify_and_prune, reset_opacity
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats
from sgs_tpu_torch.ops.ssim import l1_loss, psnr
from sgs_tpu_torch.parallel import data_parallel, hybrid, mesh as mesh_lib
from sgs_tpu_torch.train import checkpoint as ckpt
from sgs_tpu_torch.train.loop import TrainState, eval_render, train_step
from sgs_tpu_torch.viewer import network_gui
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


PARALLEL_MODES = ("none", "dp", "hybrid")


def _check_pipeline(pipe: PipelineParams) -> str:
    """The render mode of the pipeline flags (`check_rasterizer`)."""
    if pipe.parallel not in PARALLEL_MODES:
        raise ValueError(f"unknown --parallel mode {pipe.parallel!r}")
    mode = check_rasterizer(pipe)
    if mode == "rect" and pipe.parallel == "hybrid":
        raise NotImplementedError("hybrid training renders its bands with tight culling only")
    return mode


def _sample_like_bucket_sizing(py_rng: random.Random, cams: list) -> None:
    if len(cams) > BUCKET_SAMPLE:
        py_rng.sample(cams, BUCKET_SAMPLE)


class _Parallel:
    """The mesh of a --parallel run and the state moves each mode needs."""

    def __init__(self, pipe: PipelineParams, dev: torch.device):
        self.mode = pipe.parallel
        if self.mode == "dp":
            self.mesh = mesh_lib.make_mesh(None, ("data",), dev.type)
        elif pipe.parallel_mesh:
            d_n, g_n = (int(x) for x in pipe.parallel_mesh.lower().split("x"))
            self.mesh = mesh_lib.make_mesh((d_n, g_n), ("data", "gauss"), dev.type)
        else:
            self.mesh = mesh_lib.make_hybrid_mesh(dev.type)
        if self.mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh holds {self.mesh.size()} ranks of {dist.get_world_size()}")
        _, self.data_rank, self.dp_n = mesh_lib.axis(self.mesh, "data")
        self.hy_g = mesh_lib.axis(self.mesh, "gauss")[2] if self.mode == "hybrid" else 1
        self.rank0 = dist.get_rank() == 0
        self.compact = bool(pipe.hy_compact)
        self.balance = bool(pipe.hy_balance)
        self.band_offsets = None  # balanced band boundaries
        self.band_pad = 0  # tile rows every band renders (0: equal bands)
        self.band_sized = False
        if self.mode == "dp":
            print(f"data-parallel training over {self.dp_n} ranks (camera batch = {self.dp_n})")
        else:
            print(f"hybrid training over {{'data': {self.dp_n}, 'gauss': {self.hy_g}}} "
                  f"(camera batch = {self.dp_n}, {self.hy_g} Gaussian shards)")

    def place(self, state: TrainState) -> TrainState:
        """A full state, identical on every rank, into this mode's layout."""
        if self.mode == "dp":
            return data_parallel.replicate_state(state, self.mesh)
        return hybrid.place_hybrid_state(state, self.mesh)

    def full(self, state: TrainState) -> TrainState:
        """The full state on every rank (a collective in hybrid)."""
        return state if self.mode == "dp" else hybrid.gather_hybrid_state(state, self.mesh)

    def balance_bands(self, state: TrainState, train_cams: list, py_rng: random.Random) -> int:
        """Balanced band offsets from a sample (rank 0's, broadcast); returns
        the sample's pad_tiles."""
        offsets, pad = hybrid.balance_from_sample(self.full(state).model, train_cams, py_rng, self.hy_g)
        packed = torch.tensor([*offsets.tolist(), pad], dtype=torch.int64, device=state.model.device)
        dist.broadcast(packed, src=0)
        self.band_offsets = packed[:-1].tolist()
        return int(packed[-1])

    def step(self, state, cams_b, bg, lrs, active_sh_degree, opt, dataset, iteration, py_rng,
             train_cams, rasterizer):
        cam_batch = data_parallel.stack_cameras([c.camera for c in cams_b])
        gt_batch = torch.stack([c.gt_image for c in cams_b])
        cam_b, gt_b = data_parallel.shard_camera_batch(cam_batch, gt_batch, self.mesh)
        apply_update = iteration < opt.iterations
        if self.mode == "dp":
            step = data_parallel.make_dp_train_step(
                self.mesh, active_sh_degree, lambda_dssim=opt.lambda_dssim,
                freeze_xyz=dataset.freeze_xyz, mode=rasterizer, apply_update=apply_update)
            return step(state, cam_b, gt_b, bg, lrs)
        if not self.band_sized:
            if self.balance:
                self.band_pad = self.balance_bands(state, train_cams, py_rng)
                print(f"hybrid balanced bands: offsets {self.band_offsets}, pad {self.band_pad} tiles")
            hybrid.band_sizing_draws(py_rng, train_cams, self.compact)
            self.band_sized = True
        step = hybrid.make_hybrid_train_step(
            self.mesh, active_sh_degree, cam_batch.image_width, cam_batch.image_height,
            lambda_dssim=opt.lambda_dssim, freeze_xyz=dataset.freeze_xyz,
            apply_update=apply_update, band_pad_tiles=self.band_pad, compact=self.compact)
        return step(state, cam_b, gt_b, bg, lrs, self.band_offsets)

    def after_densify(self, state: TrainState, train_cams: list, py_rng: random.Random) -> None:
        """JAX's re-sizing after a densify: new balanced offsets (the pad
        grows, or shrinks on 2x slack) and the band bucket's draws."""
        if self.mode != "hybrid" or not self.band_sized:
            return
        if self.balance:
            new_pad = self.balance_bands(state, train_cams, py_rng)
            if new_pad > self.band_pad or new_pad * 2 <= self.band_pad:
                self.band_pad = new_pad
        hybrid.band_sizing_draws(py_rng, train_cams, compact=False)


def training(dataset: ModelParams, opt: OptimizationParams, pipe: PipelineParams,
             testing_iterations: List[int], saving_iterations: List[int],
             checkpoint_iterations: List[int], checkpoint_path: Optional[str] = None,
             scene=None, seed: int = 0, device: "str | torch.device" = "cuda") -> TrainState:
    from sgs_tpu_torch.data.scene import Scene

    mode = _check_pipeline(pipe)
    par = None
    if pipe.parallel != "none":
        dev = mesh_lib.init_distributed(device)
        par = _Parallel(pipe, dev)
    else:
        dev = resolve_device(device)
    writer = par is None or par.rank0
    if scene is None:
        scene = Scene(dataset, device=dev)
    model_path = dataset.model_path
    tsv = None
    if writer:
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
    if pipe.rasterizer == "tiled":
        _sample_like_bucket_sizing(py_rng, train_cams)
    if par is not None:
        state = par.place(state)

    def pop_camera():
        nonlocal viewpoint_stack
        if not viewpoint_stack:
            viewpoint_stack = list(train_cams)
        return viewpoint_stack.pop(py_rng.randint(0, len(viewpoint_stack) - 1))

    t_start = time.time()
    nonfinite_total = 0
    for iteration in range(first_iter + 1, opt.iterations + 1):
        if par is None or (par.mode == "dp" and par.rank0):
            network_gui.serve(
                lambda cam, sm: eval_render(state.model, cam, bg_color, active_sh_degree, mode),
                dataset.source_path, iteration, opt.iterations, dev,
            )
        if iteration % 1000 == 0 and active_sh_degree < dataset.sh_degree:
            active_sh_degree += 1
        if par is None:
            cam = pop_camera()
        else:
            cams_b = [pop_camera() for _ in range(par.dp_n)]
        if opt.random_background:
            bg = torch.rand((3,), generator=gen, dtype=torch.float32, device=dev)
        else:
            bg = bg_color
        lrs = make_lr_dict(opt, spatial_lr_scale, iteration)
        if par is None:
            state, metrics = train_step(
                state, cam.camera, cam.gt_image, bg, lrs, active_sh_degree=active_sh_degree,
                lambda_dssim=opt.lambda_dssim, freeze_xyz=dataset.freeze_xyz,
                apply_update=iteration < opt.iterations, mode=mode,
            )
        else:
            state, metrics = par.step(state, cams_b, bg, lrs, active_sh_degree, opt, dataset,
                                      iteration, py_rng, train_cams, mode)
        nfg = int(metrics["nonfinite_grads"])
        nonfinite_total += nfg
        if nfg:
            print(f"\n[ITER {iteration}] WARNING: {nfg} non-finite gradient elements zeroed "
                  "this step (degenerate splat geometry)")

        reporting = iteration in testing_iterations or iteration in saving_iterations
        full = par.full(state) if par is not None and reporting else state
        if writer and iteration in testing_iterations:
            training_report(tsv, iteration, scene, full.model, active_sh_degree, bg_color,
                            mode=mode)
        if writer and iteration in saving_iterations:
            print(f"\n[ITER {iteration}] Saving Gaussians")
            scene.save(full.model, iteration)

        if iteration < opt.densify_until_iter:
            if iteration > opt.densify_from_iter and iteration % opt.densification_interval == 0:
                full = state if par is None else par.full(state)
                cap = full.model.capacity
                if cap - full.model.num_alive < GROW_FREE_FRACTION * cap:
                    new_cap = int(-(-cap * GROW_FACTOR // 256) * 256)
                    print(f"\n[ITER {iteration}] Growing pool {cap} -> {new_cap}")
                    full = grow_state(full, new_cap)
                size_threshold = 20.0 if iteration > opt.opacity_reset_interval else 0.0
                new_model, new_adam, new_stats, info = densify_and_prune(
                    full.model, full.adam, full.stats,
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
                if pipe.rasterizer == "tiled":
                    _sample_like_bucket_sizing(py_rng, train_cams)
                if par is not None:
                    state = par.place(state)
                    par.after_densify(state, train_cams, py_rng)
            if iteration % opt.opacity_reset_interval == 0 or (
                dataset.white_background and iteration == opt.densify_from_iter
            ):
                new_model, new_adam = reset_opacity(state.model, state.adam)
                state = TrainState(model=new_model, adam=new_adam, stats=state.stats)

        if iteration in checkpoint_iterations:
            full = state if par is None else par.full(state)
            if writer:
                print(f"\n[ITER {iteration}] Saving Checkpoint")
                ckpt.save_checkpoint(os.path.join(model_path, f"chkpnt{iteration}.npz"), full,
                                     iteration, active_sh_degree, spatial_lr_scale)

    if tsv is not None:
        tsv.close()
    elapsed = time.time() - t_start
    iters = opt.iterations - first_iter
    if iters > 0:
        print(f"\nTrained {iters} iterations in {elapsed:.1f}s ({iters / elapsed:.2f} it/s)")
        print(f"nonfinite_grads: {nonfinite_total} elements zeroed over {iters} steps")
    return state if par is None else par.full(state)


def training_report(tsv, iteration: int, scene, model, active_sh_degree: int,
                    bg_color: torch.Tensor, mode: str = "reference",
                    full_train_set: bool = False) -> None:
    """Mean L1 and PSNR over the test views and over train views 5..29
    (every train view with `full_train_set`, as get_psnr asks), rendered
    by the rasterizer of `mode` (JAX's default: the oracle); the test
    numbers become a losses.tsv row."""
    train_cams = scene.getTrainCameras()
    if full_train_set:
        train_eval = list(train_cams)
    else:
        train_eval = [train_cams[i % len(train_cams)] for i in range(5, 30)] if train_cams else []
    n_gaussians = model.num_alive
    for name, cams in (("test", scene.getTestCameras()), ("train", train_eval)):
        if not cams:
            continue
        l1_sum, psnr_sum = 0.0, 0.0
        for cam in cams:
            image = eval_render(model, cam.camera, bg_color, active_sh_degree, mode)
            gt = torch.clamp(cam.gt_image, 0.0, 1.0)
            l1_sum += float(l1_loss(image, gt))
            psnr_sum += float(psnr(image, gt))
        l1_avg, psnr_avg = l1_sum / len(cams), psnr_sum / len(cams)
        print(f"\n[ITER {iteration}] Evaluating {name}: L1 {l1_avg} PSNR {psnr_avg}")
        print(f"# of Gaussians: {n_gaussians}")
        if name == "test" and tsv is not None:
            tsv.write(f"{iteration}\t{l1_avg}\t{psnr_avg}\t{n_gaussians}\n")
            tsv.flush()
