#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sgs_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: the six CUDA sources built cold from `sgs_tpu_torch/csrc/`,
     with the L2 read probe (`csrc/l2_read.cu`) and Kernel F's PR 10 alpha
     path (`tools/scan_ablation.py`'s `alpha_pr10` variant of
     `exp_forward.cu`), one nvcc per source, started together;
  3. kernels against their plain PyTorch versions on the card: Kernels A
     (raster forward) and C (raster backward), bit for bit, on a seeded
     random scene with an empty tile, a saturated tile and a width that
     is not a multiple of 16, and on a scene with one Gaussian covering
     more than 500 tiles (a long run for C's reduction) and a tile list
     longer than 1,024 (a long walk); C also run twice for a bitwise
     check, and A and C run again with the tiles in raster order in place
     of binning's longest-first schedule, which must give the same bits;
     Kernels B and D (SSIM forward and backward), bit for bit, at six
     sizes from one smaller than a tile to 1080x1920, each also twice, D
     also without dy; Kernels E, F and G (the forward-raster experiments)
     on the random scene binned by rect and packed into rows
     (`ops/rows.py`), and on the edge scene (`exp_scene.edge_scene`:
     tiles of 1 row back to back, of 33 and 40 rows, a tile saturated
     mid-row and one with warps that hold no live pixel), every mode and
     krows, each twice: E and G's hs and nocp and every F mode bit for
     bit, mxu within its stated tolerance; the random scene must hold
     records that F alpha's warps skip and records they do not;
     Kernels H, I and J (the gather experiments) at 32, 37 (not a whole
     number of 8-row grid steps) and 1,100 rows (J over 9 blocks, the
     last ragged), windows starting at the table's end, and K from a
     row-major and a field-major table at 16 and 8 lanes, rows a whole
     number of 256-row tiles, a ragged last tile and rows not a multiple
     of 4, each twice, bit for bit;
  4. the render slice: the port's render and metrics entry points on the
     trained flagship model (assets/flagship/point_cloud.ply) and the
     8-view test split of data/flagship800, held per view to the JAX
     package's committed numbers (assets/flagship/per_view.json,
     results.json), launch counts reset just before and read just after;
  5. the training slice at full width: a JAX-format checkpoint of the
     flagship (161,809 Gaussians, SH degree 3, Adam zeroed, iteration
     29,990) goes through `python -m sgs_tpu_torch.train --start_checkpoint`
     (run in this process) for 10 steps, with the launch counts of A-D
     reset before and read after (each must equal the steps); one step's
     parameter gradients through the kernels are held to the plain path's
     on the same inputs, C equals its plain version bit for bit on the
     step's inputs, and one step is split into its stages by CUDA events,
     Kernel C's walk and reduction apart;
  6. training from scratch: 100 iterations from data/flagship800's
     points3d.ply with densification and the test report, which must
     lower the test L1 and change the Gaussian count; the saved PLY is
     rendered through `python -m sgs_tpu_torch.render` with the argv that
     `full_eval.py` passes (`--iteration N -s <scene> -m <model> --quiet
     --eval --skip_train`);
  7. kernel times against their plain versions, bounds and library calls
     at the main path's shapes (flagship view 0), Kernel C's walk and
     reduction also timed apart, and A and C's walk also with the tiles
     in raster order (what the longest-first schedule buys);
  8. the forward-raster experiments at 1920x1080 with 100,000 Gaussians
     (`tools/exp_scene.py`): the scene built once and the three CLIs
     (`python -m sgs_tpu_torch.tools.exp_fwd`, `exp_fwd2` and
     `exp_transposed`, through their `run`) driven on it in this process,
     with the launch counts reset before and read after, every
     non-ablation variant held to Kernel A on the same bins; then E, F and
     G in every mode and krows against their plain versions on the same
     rows, E and G mxu three times more with a digest of every state, the
     scene's digest (its packed rows, tile rows and schedule), the share of
     walked warps with no live pixel, the share of F alpha's (row, slot,
     warp) triples whose exp the warp skips, F alpha at (krows, out_cols)
     (8, 8), (8, 1) and (32, 1) timed in turns against PR 10's alpha path
     (the same bits), and the bounds (`tools/exp_bounds.py`);
     a failed mxu check names the row, tile and pixel of its largest
     error, whether the tile's skip votes differ and whether the pixel is
     at a cut;
  9. the gather experiments at the scripts' full sizes: the three CLIs
     (`python -m sgs_tpu_torch.tools.exp_vmem_gather`, `exp_dma_gather`
     and `exp_gather_layout`, through their `run`) in this process, with
     the launch counts reset before and read after (H, I, J and K must
     launch, A-G not); then H-K against their plain versions on the same
     inputs, twice, bit for bit, the plain versions' and the library
     calls' ms, the card's L2 read rate (`tools/l2_rate.py`), and the
     bounds (`tools/exp_bounds.py`; H's the larger of its HBM bytes and
     its 132 MB of record reads at that L2 rate);
 10. the latent/structured model (`data/lgm400`, 2,000 structures x 8
     Gaussians at 400x400): (a) the committed snapshot
     (`assets/lgm/point_cloud.ply`) through `python -m
     sgs_tpu_torch.render` and `python -m sgs_tpu_torch.metrics`, held
     per view to `assets/lgm/per_view.json` (the cfg_args written from
     `runs/lgm_r5/cfg_args`'s values), launch counts reset before and
     read after; (b) one step at full width from the port's own seeded
     init (the CLI's 2,000 points of the 20,000): Kernels A and C against
     their plain versions bit for bit on the step's fat early splats, the
     image and every leaf's gradient through A-D against the plain path's,
     and the step split into decode, render, backward and Adam; (c)
     `python -m sgs_tpu_torch.train_lgm` from scratch for 3,000
     iterations (in this process, the counts reset before and read
     after: A once a step and once per report view, B, C and D once a
     step), whose test PSNR must rise from 1,000 to 3,000 and end within
     1.0 dB of the JAX run's (`runs/lgm_r5.log`); then A-D's device ms
     on the LGM's shapes at iterations 1, 1,000 and 3,000;
 11. a `{"kernels": [...]}` line, the device line, and last the result
     line `{"ok": true, "device": {...}}`.

Any failed phase raises and the script exits nonzero. It needs the
repository around it and a CUDA device; without either it fails before
printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.core.projection import TILE, tile_rect
from sgs_tpu_torch.data.ply import load_gaussian_ply
from sgs_tpu_torch.data.readers import read_cameras_from_transforms, read_nerf_synthetic_split
from sgs_tpu_torch.data.scene import Scene, get_nerfpp_norm
from sgs_tpu_torch.metrics import evaluate, read_image
from sgs_tpu_torch.metrics import main as metrics_main
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel, default_capacity
from sgs_tpu_torch.models.latent import LatentGaussianModel
from sgs_tpu_torch.ops import build, exp_forward, flat_raster, gather, ssim as ssim_ops
from sgs_tpu_torch.ops.ssim import l1_loss
from sgs_tpu_torch.render.cli import main as render_main
from sgs_tpu_torch.render.cli import render_sets
from sgs_tpu_torch.render.pipeline import project_and_shade, render
from sgs_tpu_torch.render.tiled import bin_gaussians, kernel_args
from sgs_tpu_torch.tools import (exp_bounds, exp_dma_gather, exp_fwd, exp_fwd2, exp_gather_layout,
                                 exp_scene, exp_transposed, exp_vmem_gather, gather_inputs, l2_rate,
                                 scan_ablation)
# the bounds' peak rates (H100 SXM, NVIDIA's data sheet) are defined there
from sgs_tpu_torch.tools.exp_bounds import bound_ms
from sgs_tpu_torch.tools.ssim_times import time_ms
from sgs_tpu_torch.train.__main__ import main as train_main
from sgs_tpu_torch.train.checkpoint import save_checkpoint
from sgs_tpu_torch.train import lgm_trainer
from sgs_tpu_torch.train.loop import TrainState, eval_render, train_step
from sgs_tpu_torch.train.optim import AdamState, TreeAdamState, adam_tree_update, adam_update, make_lr_dict
from sgs_tpu_torch.train_lgm import main as train_lgm_main
from sgs_tpu_torch.utils.config import ModelParams, OptimizationParams, PipelineParams, save_cfg_args

ROOT = Path(__file__).resolve().parent
FLAGSHIP_PLY = ROOT / "assets" / "flagship" / "point_cloud.ply"
FLAGSHIP_SCENE = ROOT / "data" / "flagship800"
FLAGSHIP_PER_VIEW = ROOT / "assets" / "flagship" / "per_view.json"
FLAGSHIP_RESULTS = ROOT / "assets" / "flagship" / "results.json"
SMOKE_DIR = ROOT / "build" / "smoke" / "flagship"
TRAIN_DIR = ROOT / "build" / "smoke" / "train_flagship"
SCRATCH_DIR = ROOT / "build" / "smoke" / "train_scratch"
METHOD = "ours_15000"
KERNELS = (flat_raster.KERNEL, ssim_ops.KERNEL, flat_raster.BACKWARD, ssim_ops.BACKWARD,
           exp_forward.KERNEL, gather.KERNEL)
# built beside the kernels, launched only to measure: the L2 read probe
# and Kernel F's alpha path as PR 10 had it (phase 8 times it in turns)
PROBE = l2_rate.KERNEL
OLD_ALPHA = "alpha_pr10"
EXP_COUNTS = (exp_forward.E, exp_forward.F, exp_forward.G, gather.H, gather.I, gather.J, gather.K)
# the full-width training run: 10 steps to the end of a 30k schedule
TRAIN_FROM, TRAIN_TO = 29_990, 30_000
SCRATCH_ITERS = 100
# The flagship's training config (runs/flagship_r5/cfg_args): black
# background, full resolution, SH degree 3.
WHITE_BACKGROUND = False
SH_DEGREE = 3

PSNR_BAR, SSIM_BAR = 0.02, 5e-4
# Kernels A-D equal their plain versions bit for bit (the same arithmetic
# in the same order, --fmad=false). The training step's parameter
# gradients through the kernels against the plain path's: rtol 1e-4 plus
# 1e-6 of each field's largest gradient.
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-6
# (7, 9) is smaller than a tile; (100, 244) takes the 16-byte loads with
# tiles ragged both ways; 1080x1920 is ragged along H only (1920 = 60 x 32)
SSIM_SIZES = [(7, 9), (37, 53), (64, 128), (100, 244), (800, 800), (1080, 1920)]
# The latent/structured model: data/lgm400 (48 train and 8 test views at
# 400x400), the JAX run's command (assets/lgm/README.md) and config
# (runs/lgm_r5/cfg_args: SH degree 0, black background, eval).
LGM_SCENE = ROOT / "data" / "lgm400"
LGM_PLY = ROOT / "assets" / "lgm" / "point_cloud.ply"
LGM_PER_VIEW = ROOT / "assets" / "lgm" / "per_view.json"
LGM_RESULTS = ROOT / "assets" / "lgm" / "results.json"
LGM_RENDER_DIR = ROOT / "build" / "smoke" / "lgm"
LGM_TRAIN_DIR = ROOT / "build" / "smoke" / "train_lgm"
LGM_METHOD = "ours_3000"
LGM_DOWNSAMPLE = 10
LGM_ITERS = 3000
LGM_TESTS = (1000, 2000, 3000)
# The JAX run's report PSNR (runs/lgm_r5.log: TPU v5e, 3,000 iterations
# from the same 2,000 points with JAX's own random latents and decoder)
JAX_LGM_TEST_PSNR = {1000: 17.849565267562866, 2000: 19.90630555152893, 3000: 21.300128698349}
JAX_LGM_TRAIN_PSNR = {1000: 18.165253162384033, 2000: 20.277136087417603, 3000: 21.700287342071533}
# the port's init cannot be JAX's (no JAX on the card), and JAX's run
# dropped 28,736 splats for one step at iteration 30 (its instance bucket
# overflowed): the end of the run is held to within 1.0 dB
LGM_PSNR_BAR = 1.0
# the LGM step's image through Kernels A-D against the plain path's
LGM_IMAGE_ATOL = 3e-5


def say(*parts) -> None:
    print(*parts, flush=True)


def time_cuda(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` calls by CUDA events, host time included
    (a stage of the host-bound training step)."""
    return time_ms(fn, reps, hide_host=False)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    resolve_device("cuda")
    say(f"[1 device] nvidia-smi: {smi} | torch: {torch.cuda.get_device_name(0)} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")
    return smi


def phase_build() -> build.CudaKernel:
    """Build the kernels, the probe and PR 10's alpha path together;
    returns the last."""
    t0 = time.perf_counter()
    old_alpha = scan_ablation.variant_kernel(OLD_ALPHA)
    build.build_all([*KERNELS, PROBE, old_alpha])
    total = time.perf_counter() - t0
    for k in (*KERNELS, PROBE, old_alpha):
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        say(f"[2 build] {k.source.name}: {k.build_seconds if k.build_seconds is not None else 0.0:.2f} s "
            f"(cached: {k.build_seconds is None}) {' | '.join(regs)}")
    say(f"[2 build] {len(KERNELS)} sources, the probe and PR 10's alpha path ready in {total:.2f} s")
    return old_alpha


def reset_counts() -> None:
    for k in KERNELS + EXP_COUNTS:
        k.launches = 0


def read_counts() -> dict:
    return {"A": flat_raster.KERNEL.launches, "B": ssim_ops.KERNEL.launches,
            "C": flat_raster.BACKWARD.launches, "D": ssim_ops.BACKWARD.launches,
            **{c.name: c.launches for c in EXP_COUNTS}}


def only(**counts) -> dict:
    """The launch counts of a run that launches only the named kernels."""
    return {k: counts.get(k, 0) for k in "ABCDEFGHIJK"}


def random_raster_scene(dev, n=2000, width=250, height=190, seed=0):
    """Seeded 2-D Gaussians with an empty tile (tile 0 is kept clear) and
    a saturated tile (a stack of opaque splats on one tile)."""
    rng = np.random.default_rng(seed)
    n_stack = 64
    mean2d = rng.uniform(-10, [width + 10, height + 10], (n, 2))
    stack_c = np.array([8 * TILE + 8.0, 6 * TILE + 8.0])
    mean2d[:n_stack] = stack_c + rng.uniform(-2, 2, (n_stack, 2))
    l1 = rng.uniform(0.005, 0.5, n)
    l2 = rng.uniform(0.005, 0.5, n)
    l1[:n_stack] = l2[:n_stack] = 0.02
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    conic = np.stack([l1 * c * c + l2 * s * s, (l1 - l2) * s * c, l1 * s * s + l2 * c * c], 1)
    opac = rng.uniform(0.001, 0.99, n)
    opac[:n_stack] = 0.95
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    radius = torch.as_tensor(np.ceil(3.0 / np.sqrt(np.minimum(l1, l2))).astype(np.int32), device=dev)
    mean2d_t = f(mean2d)
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    min_x, _, min_y, _ = tile_rect(mean2d_t, radius.float(), tiles_x, tiles_y)
    valid = torch.as_tensor(rng.uniform(size=n) > 0.05, device=dev) & ~((min_x == 0) & (min_y == 0))
    return dict(mean2d=mean2d_t, depth=f(rng.uniform(0.5, 10.0, n)), conic=f(conic),
                rgb=f(rng.uniform(0, 1, (n, 3))), opacity=f(opac), radius=radius,
                valid=valid)


def raster_inputs(sc: dict, width: int, height: int):
    """Bin a scene as the render path does; returns (bins, Kernel A's args)."""
    bins = bin_gaussians(sc["mean2d"], sc["conic"], sc["opacity"], sc["depth"], sc["radius"],
                         sc["valid"], width, height)
    return bins, kernel_args(bins, sc["mean2d"], sc["conic"], sc["opacity"], sc["rgb"], width, height)


def compare_raster(args) -> float:
    """Kernel A against its plain version, bit for bit; returns max |err| (0)."""
    got = flat_raster.rasterize_tiles(*args)
    want = flat_raster.rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("image", "t_final", "n_contrib"), got, want):
        if not torch.equal(g, w):
            bad = int((g != w).sum())
            raise AssertionError(f"Kernel A {name} differs from its plain version at {bad} pixels, "
                                 f"max |err| {float((g - w).abs().max())}")
    return 0.0


def ssim_pair(h, w, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.15, x.shape), 0, 1).astype(np.float32)
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)


def compare_ssim(x, y) -> float:
    """Kernel B twice and against its plain version, bit for bit; returns
    max |err| (0)."""
    got_v, again_v = float(ssim_ops.ssim_forward(x, y)), float(ssim_ops.ssim_forward(x, y))
    want_v = float(ssim_ops.ssim_plain(x, y))
    if got_v != again_v:
        raise AssertionError(f"Kernel B is not bitwise repeatable: {got_v} vs {again_v}")
    if got_v != want_v:
        raise AssertionError(f"Kernel B {got_v!r} differs from its plain version {want_v!r}")
    return 0.0


def backward_args(bins, args, dev, seed):
    """Kernel C's arguments for a binned scene and a seeded cotangent."""
    _, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    g = torch.Generator(device=dev).manual_seed(seed)
    dc = torch.randn((3, args[6], args[5]), generator=g, device=dev)
    bg = torch.rand(3, generator=g, device=dev)
    return (*args, t_final, n_contrib, dc, bg, bins["perm"], bins["rank_start"], bins["order"])


def compare_raster_backward(bargs) -> float:
    """Kernel C twice and against its plain version, bit for bit; returns
    max |err| (0)."""
    got = flat_raster.rasterize_tiles_backward(*bargs)
    again = flat_raster.rasterize_tiles_backward(*bargs)
    want = flat_raster.rasterize_tiles_backward_plain(*bargs)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("Kernel C is not bitwise repeatable")
    if not torch.equal(got, want) or not torch.isfinite(got).all():
        bad = int((got != want).sum())
        raise AssertionError(f"Kernel C differs from its plain version at {bad} elements: "
                             f"max |err| {float((got - want).abs().max())}")
    return 0.0


def compare_schedules(bins, args, bargs) -> None:
    """A and C with the tiles in raster order give the bits they give with
    binning's longest-first schedule."""
    raster_order = torch.arange(args[3].shape[0], dtype=torch.int32, device=args[3].device)
    alt = (*args[:3], raster_order, *args[4:])
    for g, w in zip(flat_raster.rasterize_tiles(*alt), flat_raster.rasterize_tiles(*args)):
        if not torch.equal(g, w):
            raise AssertionError("Kernel A depends on the tile schedule")
    got = flat_raster.rasterize_tiles_backward(*alt, *bargs[7:])
    if not torch.equal(got, flat_raster.rasterize_tiles_backward(*bargs)):
        raise AssertionError("Kernel C depends on the tile schedule")


def long_run_scene(dev, width=512, height=384, seed=2):
    """1,500 random splats, one wide splat over most of the image (a run of
    more than 500 instances) and 1,100 faint broad splats stacked on one
    tile (a list longer than 1,024 that never saturates)."""
    sc = random_raster_scene(dev, n=1500, width=width, height=height, seed=seed)
    rng = np.random.default_rng(seed + 1)
    n_stack = 1100
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    mean2d = np.concatenate([[[width / 2, height / 2]],
                             np.array([5 * TILE + 8.0, 4 * TILE + 8.0]) + rng.uniform(-3, 3, (n_stack, 2))])
    conic = np.concatenate([[[1e-4, 0.0, 1.5e-4]], np.tile([0.002, 0.0, 0.002], (n_stack, 1))])
    opac = np.concatenate([[0.6], rng.uniform(0.0045, 0.006, n_stack)])
    radius = np.concatenate([[300], np.full(n_stack, 68)]).astype(np.int32)
    extra = dict(mean2d=f(mean2d), depth=f(rng.uniform(0.5, 10.0, n_stack + 1)), conic=f(conic),
                 rgb=f(rng.uniform(0, 1, (n_stack + 1, 3))), opacity=f(opac),
                 radius=torch.as_tensor(radius, device=dev),
                 valid=torch.ones(n_stack + 1, dtype=torch.bool, device=dev))
    return {k: torch.cat([sc[k], extra[k]]) for k in sc}


def compare_ssim_backward(x, y, cot) -> float:
    """Kernel D twice, and without dy, against its plain version, bit for
    bit; returns max |err| (0)."""
    got = ssim_ops.ssim_backward(x, y, cot)
    again = ssim_ops.ssim_backward(x, y, cot)
    dx_only, none = ssim_ops.ssim_backward(x, y, cot, with_dy=False)
    want = ssim_ops.ssim_backward_plain(x, y, cot)
    torch.cuda.synchronize()
    if not all(torch.equal(g, a) for g, a in zip(got, again)):
        raise AssertionError("Kernel D is not bitwise repeatable")
    if none is not None or not torch.equal(dx_only, want[0]):
        raise AssertionError("Kernel D without dy differs from its plain version's dx")
    for name, g, w in zip(("dx", "dy"), got, want):
        if not torch.equal(g, w) or not torch.isfinite(g).all():
            raise AssertionError(f"Kernel D {name} differs from its plain version at {int((g != w).sum())} "
                                 f"elements: max |err| {float((g - w).abs().max())}")
    return 0.0


def check_rows(name, got, again, want, mode, pk, near) -> float:
    """One kernel's per-row state against its repeat and its plain
    version on the rows `pk`: equal bit for bit, or for mxu within
    MXU_ATOL with no last_contrib difference off the pixels at a cut; a
    failed mxu check names the site of its largest error
    (`exp_forward.error_site`). Returns max |err|."""
    if not torch.equal(got, again):
        raise AssertionError(f"Kernel {name} is not bitwise repeatable")
    if mode != "mxu":
        if not torch.equal(got, want):
            raise AssertionError(f"Kernel {name} differs from its plain version at "
                                 f"{int((got != want).sum())} elements")
        return 0.0
    err = exp_forward.rows_error(got, want, pk["row_tile"], near)
    if not err["finite"] or err["values"] > exp_forward.MXU_ATOL or err["last_contrib_flips"]:
        site = exp_forward.error_site(got, want, pk["row_tile"], pk["chunk_row_start"], near)
        raise AssertionError(f"Kernel {name} differs from its plain version: {err}; "
                             f"largest error off the pixels at a cut: {site}")
    return err["values"]


def compare_experiments(pk: dict, krows_list, near=None) -> dict:
    """Kernels E, F and G in every mode, each twice, against their plain
    versions on the rows `pk` (`near`: its pixels at a cut, computed when
    not given). Returns the max |err| of each."""
    crs, nch, sched, tx = pk["chunk_row_start"], pk["n_chunks"], pk["schedule"], pk["tiles_x"]
    fm, im = pk["packed_fm"], pk["packed"]
    if near is None:
        near = exp_forward.near_cut(fm, crs, nch, tx)
    errs = {"E": 0.0, "F": 0.0, "G": 0.0}
    for mode in exp_forward.SCANS:
        want = exp_forward.forward_rows_plain(fm, crs, nch, sched, tx, mode)
        for kr in krows_list:
            run = lambda: exp_forward.forward_rows(fm, crs, nch, sched, tx, mode, kr)
            errs["E"] = max(errs["E"], check_rows(f"E {mode} krows {kr}", run(), run(), want, mode, pk, near))
        if mode == "nocp":
            continue
        want = exp_forward.transposed_rows_plain(im, crs, nch, sched, tx, mode).transpose(1, 2)
        for kr in krows_list:
            run = lambda: exp_forward.transposed_rows(im, crs, nch, sched, tx, mode, kr).transpose(1, 2)
            errs["G"] = max(errs["G"], check_rows(f"G {mode} krows {kr}", run(), run(), want, mode, pk, near))
    for mode in exp_forward.ABLATIONS:
        for oc in (8, 1):
            want = exp_forward.ablation_rows_plain(fm, crs, nch, sched, tx, mode, oc)
            for kr in krows_list:
                run = lambda: exp_forward.ablation_rows(fm, crs, nch, sched, tx, mode, kr, oc)
                got, again = run(), run()
                if mode == "empty":  # only row 0 is defined
                    got, again, want = got[:1], again[:1], want[:1]
                check_rows(f"F {mode} krows {kr} out_cols {oc}", got, again, want, mode, pk, near)
    return errs


def mxu_thrice(sc: dict, near) -> dict:
    """E and G mxu at every krows against their plain versions three times
    over, each time run twice (bitwise repeatable, `check_rows`), with
    digests of every state, so that runs and calls can be compared: the
    kernels must give the same bits in all three; whether the plain
    versions do is printed. Returns the max |err| of each kernel."""
    crs, nch, sched, tx = sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"]
    fm, im = sc["packed_fm"], sc["packed"]
    cases = {"E": (lambda: exp_forward.forward_rows_plain(fm, crs, nch, sched, tx, "mxu"),
                   lambda kr: exp_forward.forward_rows(fm, crs, nch, sched, tx, "mxu", kr)),
             "G": (lambda: exp_forward.transposed_rows_plain(im, crs, nch, sched, tx, "mxu").transpose(1, 2),
                   lambda kr: exp_forward.transposed_rows(im, crs, nch, sched, tx, "mxu", kr).transpose(1, 2))}
    errs, runs = {"E": 0.0, "G": 0.0}, []
    for i in range(3):
        seen = {}
        for name, (plain, kernel) in cases.items():
            want = plain()
            seen[f"{name} plain"] = exp_scene.tensor_digest(want)
            for kr in exp_forward.KROWS:
                got = kernel(kr)
                err = check_rows(f"{name} mxu krows {kr} (run {i + 1} of 3)", got, kernel(kr), want, "mxu", sc, near)
                errs[name] = max(errs[name], err)
                seen[f"{name} krows {kr}"] = exp_scene.tensor_digest(got)
                seen[f"{name} krows {kr} |err|"] = err
        runs.append(seen)
        say(f"[8 mxu] run {i + 1} of 3: " + ", ".join(
            f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in seen.items()))
    differs = [k for k in runs[0] if any(r[k] != runs[0][k] for r in runs[1:])]
    say(f"[8 mxu] across the three runs: kernels the same bits: "
        f"{not [k for k in differs if 'plain' not in k]}, plain versions the same bits: "
        f"{not [k for k in differs if 'plain' in k]}")
    if [k for k in differs if "plain" not in k]:
        raise AssertionError(f"E or G mxu differ between runs of the same rows: {differs}")
    return errs


def phase_experiments_small(dev) -> dict:
    """Phase 3 for Kernels E, F and G: the random scene (an empty and a
    saturated tile) packed into rows; every mode and krows against the
    plain versions; the plain versions' ms at this size."""
    width, height = 250, 190
    pk = exp_scene.pack(random_raster_scene(dev, width=width, height=height), width, height)
    sat_tile = 6 * pk["tiles_x"] + 8
    if int(pk["n_chunks"][sat_tile]) < 2 or int((pk["n_chunks"] == 0).sum()) == 0:
        raise AssertionError("the packed scene lacks its saturated or its empty tile")
    errs = compare_experiments(pk, exp_forward.KROWS)
    crs, nch, sched, tx = pk["chunk_row_start"], pk["n_chunks"], pk["schedule"], pk["tiles_x"]
    far = exp_forward.far_records(pk["packed_fm"], pk["row_tile"], tx, pk["num_tiles"])
    if not 0 < far["far"] < far["slot_warps"]:
        raise AssertionError(f"F alpha's exp skip takes none or all of the random scene's records: {far}")
    plain = {
        "E": time_cuda(lambda: exp_forward.forward_rows_plain(pk["packed_fm"], crs, nch, sched, tx), 3),
        "F": time_cuda(lambda: exp_forward.ablation_rows_plain(pk["packed_fm"], crs, nch, sched, tx), 3),
        "G": time_cuda(lambda: exp_forward.transposed_rows_plain(pk["packed"], crs, nch, sched, tx), 3),
    }
    say(f"[3 kernels] E, F, G on rows {width}x{height}: {pk['rows_used']} rows, "
        f"{int((nch == 0).sum())} empty tiles, the saturated tile {int(nch[sat_tile])} rows: "
        f"E hs/nocp, G hs and F empty/outonly/alpha (krows 8 and 32, out_cols 8 and 1) equal to "
        f"their plain versions bit for bit and repeatable; mxu max |err| E {errs['E']:.2e}, "
        f"G {errs['G']:.2e} (tolerance {exp_forward.MXU_ATOL}); F alpha's warps skip the exp of "
        f"{far['far']} of {far['slot_warps']} (row, slot, warp) triples; plain ms at this size: "
        + ", ".join(f"{k} {v:.3f}" for k, v in plain.items()))
    edge = exp_scene.edge_scene(dev)
    e = compare_experiments(edge, exp_forward.KROWS)
    hs = exp_forward.forward_rows(edge["packed_fm"], edge["chunk_row_start"], edge["n_chunks"],
                                  edge["schedule"], edge["tiles_x"], "hs")
    dead = exp_forward.dead_warps(hs, edge["row_first"], edge["row_tile"], edge["num_tiles"])
    if dead["dead_warps"] == 0:
        raise AssertionError(f"the edge scene has no warp without a live pixel: {dead}")
    say(f"[3 kernels] E, F, G on the edge scene ({edge['num_tiles']} tiles of 0 to 40 rows, "
        f"{edge['rows_used']} rows; a tile saturated mid-row, a half-saturated tile): every mode "
        f"and krows as above; mxu max |err| E {e['E']:.2e}, G {e['G']:.2e}; walked warps "
        f"without a live pixel: {dead['dead_warps']} of {dead['warps_walked']}")
    return {k: max(errs[k], e[k]) for k in errs}


def check_equal(name: str, run, want) -> None:
    """A kernel twice against its plain version's output, bit for bit."""
    got, again = run(), run()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"Kernel {name} is not bitwise repeatable")
    if not torch.equal(got, want):
        raise AssertionError(f"Kernel {name} differs from its plain version at {int((got != want).sum())} "
                             f"elements, max |err| {float((got - want).abs().max())}")


def gather_cases(table, ids, attr, starts, packed) -> list:
    """(name, kernel call, plain call) of Kernels H, I and J on one set of
    the scripts' inputs."""
    return [("H", lambda: gather.vmem_gather_steps(table, ids),
             lambda: gather.vmem_gather_steps_plain(table, ids)),
            ("I", lambda: gather.packed_sum_steps(packed), lambda: gather.packed_sum_steps_plain(packed)),
            ("J", lambda: gather.dma_gather(attr, starts), lambda: gather.dma_gather_plain(attr, starts))]


def phase_gather_small(dev) -> dict:
    """Phase 3 for Kernels H-K: H, I and J at 32, 37 and 1,100 rows with
    windows starting at m, K from both layouts at 16 and 8 lanes, each
    twice, bit for bit."""
    for rows in (32, 37, 1100):
        m = 50 * rows
        table, ids = gather_inputs.vmem_inputs(1000, rows, rows, dev)
        attr, starts = gather_inputs.dma_inputs(m, rows, rows, dev)
        at_m = int((starts[: rows // gather.KROWS * gather.KROWS] == m).sum())
        if at_m == 0:
            raise AssertionError(f"no window in the grid starts at m ({rows} rows)")
        for name, run, plain in gather_cases(table, ids, attr, starts, gather_inputs.pack(attr, starts, m)):
            check_equal(f"{name} ({rows} rows)", run, plain())
        say(f"[3 kernels] H, I, J gather experiments at {rows} rows ({at_m} windows at m): equal to "
            f"their plain versions bit for bit and repeatable")
    for rows, rec in ((16384, 16), (16388, 8), (1001, 16), (1002, 8)):
        x = torch.as_tensor(np.random.default_rng(rows).normal(size=(rows, rec)).astype(np.float32), device=dev)
        for src in (x, gather.field_major(x)):
            check_equal(f"K {gather.layout(src)} ({rows}, {rec})", lambda: gather.layout_identity(src), x)
    say("[3 kernels] K identity from row-major and field-major tables, (16384, 16), (16388, 8), "
        "(1001, 16), (1002, 8): equal to the table bit for bit and repeatable")
    return {k: 0.0 for k in "HIJK"}


def phase_kernels(dev) -> dict:
    width, height = 250, 190
    sc = random_raster_scene(dev, width=width, height=height)
    bins, args = raster_inputs(sc, width, height)
    counts = bins["tile_end"] - bins["tile_start"]
    if int((counts == 0).sum()) == 0:
        raise AssertionError("random scene has no empty tile")
    err_a = compare_raster(args)
    _, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    sat_tile = 6 * bins["tiles_x"] + 8
    centre = n_contrib[6 * TILE + 8, 8 * TILE + 8]
    if not int(centre) < int(counts[sat_tile]) or float(t_final[6 * TILE + 8, 8 * TILE + 8]) > 1e-2:
        raise AssertionError("the stacked tile did not saturate")
    say(f"[3 kernels] A raster forward: {width}x{height}, "
        f"{bins['point_list'].shape[0]} instances, {int((counts == 0).sum())} empty tiles: "
        f"equal to the plain version bit for bit, n_contrib included")
    bargs = backward_args(bins, args, dev, 1)
    err_c = compare_raster_backward(bargs)
    compare_schedules(bins, args, bargs)
    say("[3 kernels] C raster backward: same scene, equal to the plain version bit for bit, "
        "bitwise repeatable; A and C give the same bits with the tiles in raster order")

    width, height = 512, 384
    bins, args = raster_inputs(long_run_scene(dev, width, height), width, height)
    longest_run = int((bins["rank_start"][1:] - bins["rank_start"][:-1]).max())
    longest_list = int((bins["tile_end"] - bins["tile_start"]).max())
    if longest_run < 500 or longest_list <= 1024:
        raise AssertionError(f"long-run scene: longest run {longest_run}, longest list {longest_list}")
    err_a = max(err_a, compare_raster(args))
    bargs = backward_args(bins, args, dev, 3)
    err_c = max(err_c, compare_raster_backward(bargs))
    compare_schedules(bins, args, bargs)
    say(f"[3 kernels] long runs {width}x{height}: {bins['point_list'].shape[0]} instances, "
        f"longest run {longest_run} instances, longest tile list {longest_list}, deepest pixel "
        f"{int(bargs[8].max())}: A and C equal to their plain versions bit for bit, C repeatable, "
        f"both independent of the schedule")
    errs_b, errs_d = [], []
    for i, (h, w) in enumerate(SSIM_SIZES):
        x, y = ssim_pair(h, w, i, dev)
        errs_b.append(compare_ssim(x, y))
        errs_d.append(compare_ssim_backward(x, y, torch.tensor(0.7, device=dev)))
        say(f"[3 kernels] B ssim forward and D ssim backward {h}x{w}: equal to their plain "
            f"versions bit for bit, bitwise repeatable; D without dy gives the same dx")
    return {"A": err_a, "B": max(errs_b), "C": err_c, "D": max(errs_d), **phase_experiments_small(dev),
            **phase_gather_small(dev)}


def phase_slice(dev) -> dict:
    per_view = json.loads(FLAGSHIP_PER_VIEW.read_text())[METHOD]
    results = json.loads(FLAGSHIP_RESULTS.read_text())[METHOD]
    reset_counts()
    t0 = time.perf_counter()
    dataset = ModelParams(sh_degree=SH_DEGREE, source_path=str(FLAGSHIP_SCENE),
                          model_path=str(SMOKE_DIR), white_background=WHITE_BACKGROUND, eval=True)
    render_sets(dataset, 15000, PipelineParams(), skip_train=True, skip_test=False,
                ply=str(FLAGSHIP_PLY), device=dev)
    got = evaluate([str(SMOKE_DIR)], device=dev)[str(SMOKE_DIR)][METHOD]
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    mine = json.loads((SMOKE_DIR / "per_view.json").read_text())[METHOD]
    names = sorted(per_view["PSNR"])
    if sorted(mine["PSNR"]) != names:
        raise AssertionError(f"rendered views {sorted(mine['PSNR'])} != {names}")
    worst = {"psnr": 0.0, "ssim": 0.0}
    failures = []
    for name in names:
        dp = mine["PSNR"][name] - per_view["PSNR"][name]
        ds = mine["SSIM"][name] - per_view["SSIM"][name]
        worst["psnr"] = max(worst["psnr"], abs(dp))
        worst["ssim"] = max(worst["ssim"], abs(ds))
        say(f"[4 slice] {name}: PSNR {mine['PSNR'][name]:.4f} (JAX {per_view['PSNR'][name]:.4f}, "
            f"d {dp:+.5f}) SSIM {mine['SSIM'][name]:.6f} (JAX {per_view['SSIM'][name]:.6f}, d {ds:+.2e})")
        if abs(dp) > PSNR_BAR or abs(ds) > SSIM_BAR:
            failures.append(name)
    dp, ds = got["PSNR"] - results["PSNR"], got["SSIM"] - results["SSIM"]
    say(f"[4 slice] mean: PSNR {got['PSNR']:.4f} (JAX {results['PSNR']:.4f}, d {dp:+.5f}) "
        f"SSIM {got['SSIM']:.6f} (JAX {results['SSIM']:.6f}, d {ds:+.2e}); "
        f"launches A {launches['A']} B {launches['B']}; render+metrics {wall:.2f} s")
    if failures or abs(dp) > PSNR_BAR or abs(ds) > SSIM_BAR:
        raise AssertionError(f"views off the JAX numbers: {failures}, mean dPSNR {dp}, dSSIM {ds}")
    n_views = len(names)
    if launches != only(A=n_views, B=n_views):
        raise AssertionError(f"render path launches {launches}, expected A and B {n_views}")
    return {"launches": launches, "worst": worst, "views": n_views}


def conv2d_ssim(x, y, w1d):
    """Library yardstick: SSIM by two depthwise conv2d passes (timed only)."""
    f = torch.nn.functional
    stack = torch.cat([x, y, x * x, y * y, x * y])[None]
    wh = w1d.view(1, 1, 1, -1).repeat(15, 1, 1, 1)
    wv = w1d.view(1, 1, -1, 1).repeat(15, 1, 1, 1)
    m = f.conv2d(f.conv2d(stack, wh, padding=(0, 5), groups=15), wv, padding=(5, 0), groups=15)[0]
    mu1, mu2, exx, eyy, exy = m[0:3], m[3:6], m[6:9], m[9:12], m[12:15]
    c1, c2 = 0.01**2, 0.03**2
    num = (2 * mu1 * mu2 + c1) * (2 * (exy - mu1 * mu2) + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * ((exx - mu1 * mu1) + (eyy - mu2 * mu2) + c2)
    return torch.mean(num / den)


class _Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_cli(fn, argv) -> str:
    """Run a CLI entry point in this process; returns what it printed."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        fn([str(a) for a in argv])
    return tee.buf.getvalue()


def scene_extent() -> float:
    """The NeRF++ radius of data/flagship800's train cameras (the trainer's
    spatial_lr_scale), from the camera centres in transforms_train.json."""
    frames = json.loads((FLAGSHIP_SCENE / "transforms_train.json").read_text())["frames"]
    centers = np.array([np.array(f["transform_matrix"], np.float64)[:3, 3] for f in frames])
    return float(np.max(np.linalg.norm(centers - centers.mean(axis=0), axis=1))) * 1.1


def flagship_model(dev) -> GaussianModel:
    """The trained flagship in a padded pool, as the JAX trainer holds it."""
    arrays = load_gaussian_ply(str(FLAGSHIP_PLY), SH_DEGREE)
    n = arrays["xyz"].shape[0]
    model = GaussianModel.empty(default_capacity(n), SH_DEGREE, dev)
    for f in PARAM_FIELDS:
        getattr(model, f)[:n] = torch.as_tensor(arrays[f], device=dev)
    model.alive[:n] = True
    return model


def phase_train_flagship(dev, model) -> dict:
    path = TRAIN_DIR / "flagship_29990.npz"
    state = TrainState(model=model, adam=AdamState.init(model.params()),
                       stats=DensifyStats.zeros(model.capacity, dev))
    save_checkpoint(str(path), state, TRAIN_FROM, SH_DEGREE, scene_extent())
    steps = TRAIN_TO - TRAIN_FROM
    argv = ["-s", FLAGSHIP_SCENE, "-m", TRAIN_DIR, "--eval", "--start_checkpoint", path,
            "--iterations", TRAIN_TO, "--test_iterations", -1, "--checkpoint_iterations", -1,
            "--device", dev.type]
    reset_counts()
    t0 = time.perf_counter()
    out = run_cli(train_main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    n_alive = model.num_alive
    snap = load_gaussian_ply(str(TRAIN_DIR / "point_cloud" / f"iteration_{TRAIN_TO}" / "point_cloud.ply"),
                             SH_DEGREE)
    if launches != only(A=steps, B=steps, C=steps, D=steps):
        raise AssertionError(f"training launches {launches}, expected {steps} of each kernel")
    if snap["xyz"].shape[0] != n_alive or not np.isfinite(snap["xyz"]).all():
        raise AssertionError(f"saved snapshot has {snap['xyz'].shape[0]} Gaussians, expected {n_alive}")
    nf = [ln for ln in out.splitlines() if ln.startswith("nonfinite_grads:")]
    if not nf:
        raise AssertionError("the trainer did not report nonfinite_grads")
    say(f"[5 train] {steps} steps at {n_alive} Gaussians, SH degree {SH_DEGREE}, 800x800: "
        f"launches {launches}; {nf[0]}; trainer call {wall:.2f} s (scene load included)")
    return {"launches": launches, "steps": steps}


@contextlib.contextmanager
def plain_path():
    """Route the kernel wrappers of the render and loss to their plain
    versions (on the card) for a reference gradient."""
    saved = (flat_raster.rasterize_tiles, flat_raster.rasterize_tiles_backward,
             ssim_ops.ssim_forward, ssim_ops.ssim_backward)
    flat_raster.rasterize_tiles = flat_raster.rasterize_tiles_plain
    flat_raster.rasterize_tiles_backward = flat_raster.rasterize_tiles_backward_plain
    ssim_ops.ssim_forward = ssim_ops.ssim_plain
    ssim_ops.ssim_backward = ssim_ops.ssim_backward_plain
    try:
        yield
    finally:
        (flat_raster.rasterize_tiles, flat_raster.rasterize_tiles_backward,
         ssim_ops.ssim_forward, ssim_ops.ssim_backward) = saved


def step_grads(model, cam, gt, bg):
    """Gradients of the training loss for the six fields and the tap."""
    leaves = {f: getattr(model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
    tap = torch.zeros((model.capacity, 3), device=gt.device, requires_grad=True)
    out = render(cam, model.with_params(leaves).render_inputs(SH_DEGREE), bg, vspace_tap=tap)
    loss = ssim_ops.training_loss(out["render"], gt, 0.2)
    grads = torch.autograd.grad(loss, [leaves[f] for f in PARAM_FIELDS] + [tap])
    return dict(zip(PARAM_FIELDS + ("tap",), grads))


def check_grads(got: dict, want: dict) -> dict:
    """Each gradient through the kernels against the plain path's: the same
    non-finite elements, the rest within rtol GRAD_RTOL plus GRAD_ATOL_SCALE
    of the field's largest; returns max |err| / largest per field."""
    worst = {}
    for f, g in got.items():
        wv = want[f]
        fin = torch.isfinite(wv)
        if not torch.equal(fin, torch.isfinite(g)):
            raise AssertionError(f"gradient {f}: non-finite elements differ from the plain path")
        err = (g[fin] - wv[fin]).abs()
        scale = float(wv[fin].abs().max()) if fin.any() else 0.0
        if not bool((err <= GRAD_RTOL * wv[fin].abs() + GRAD_ATOL_SCALE * scale).all()):
            raise AssertionError(f"gradient {f} through the kernels differs from the plain path: "
                                 f"max |err| {float(err.max())}, scale {scale}")
        worst[f] = float(err.max()) / max(scale, 1e-30)
    return worst


def step_kernel_inputs(inputs, cam, gt, bg):
    """Kernels A-D's arguments in a training step on one view: (projection
    and shading, A's args, C's args, the image, the loss's cotangent for D)."""
    p = project_and_shade(cam, inputs)
    bins, args = raster_inputs(p, cam.image_width, cam.image_height)
    color, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    image = (color + t_final[None] * bg[:, None, None]).requires_grad_(True)
    (dc,) = torch.autograd.grad(ssim_ops.training_loss(image, gt, 0.2), image)
    bargs = (*args, t_final, n_contrib, dc.contiguous(), bg, bins["perm"], bins["rank_start"],
             bins["order"])
    return p, args, bargs, image.detach().contiguous(), torch.tensor(-0.2, device=gt.device)


def phase_step(dev, model, view) -> dict:
    """One training step on flagship test view 0: gradients through the
    kernels against the plain path's, Kernels C and D against their plain
    versions on the step's own inputs, and the step split into stages."""
    cam, gt = view.camera, view.gt_image
    bg = torch.zeros(3, device=dev)
    w, h = cam.image_width, cam.image_height
    got = step_grads(model, cam, gt, bg)
    with plain_path():
        want = step_grads(model, cam, gt, bg)
    torch.cuda.synchronize()
    worst = check_grads(got, want)

    # the step's own inputs to Kernels C and D
    p, args, bargs, img, cot = step_kernel_inputs(model.render_inputs(SH_DEGREE), cam, gt, bg)
    err_c = compare_raster_backward(bargs)
    err_d = compare_ssim_backward(img, gt, cot)
    err_b = compare_ssim(img, gt)
    say(f"[5 step] view 0: gradients through the kernels vs the plain path, max |err| / field max: "
        + ", ".join(f"{f} {v:.2e}" for f, v in worst.items())
        + f" (rtol {GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x max); B, C and D on the step's inputs "
          f"equal to their plain versions bit for bit")

    # stages of one step, CUDA events, means over the reps
    leaves = {f: getattr(model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
    grad_model = model.with_params(leaves)
    stages = {}
    stages["projection+SH"] = time_cuda(lambda: project_and_shade(cam, grad_model.render_inputs(SH_DEGREE)), 5)
    stages["binning"] = time_cuda(lambda: raster_inputs(p, w, h), 5)
    stages["A"] = time_ms(lambda: flat_raster.rasterize_tiles(*args), 10)
    stages["B"] = time_ms(lambda: ssim_ops.ssim_forward(img, gt), 20)
    inst = torch.empty((bargs[2].shape[0], flat_raster.N_GRADS), device=dev)
    stages["C walk"] = time_ms(lambda: flat_raster.raster_backward_walk(bargs, inst), 10)
    stages["C reduction"] = time_ms(lambda: flat_raster.reduce_runs(inst, bargs[12], bargs[13]), 10)
    c_ms = time_ms(lambda: flat_raster.rasterize_tiles_backward(*bargs), 10)
    stages["D"] = time_ms(lambda: ssim_ops.ssim_backward(img, gt, cot, with_dy=False), 20)
    d_both_ms = time_ms(lambda: ssim_ops.ssim_backward(img, gt, cot), 20)
    pg = project_and_shade(cam, grad_model.render_inputs(SH_DEGREE))
    outs = [pg["mean2d"], pg["conic"], pg["rgb"], pg["opacity"]]
    cots = [torch.ones_like(o) for o in outs]
    stages["autograd projection+SH"] = time_cuda(
        lambda: torch.autograd.grad(outs, list(leaves.values()), cots, retain_graph=True), 5)
    params = model.params()
    grads = {f: got[f] for f in PARAM_FIELDS}
    adam = AdamState.init(params)
    lrs = make_lr_dict(OptimizationParams(), scene_extent(), TRAIN_FROM)
    stages["Adam"] = time_cuda(lambda: adam_update(params, grads, adam, lrs, model.alive), 5)
    state = TrainState(model=model, adam=adam, stats=DensifyStats.zeros(model.capacity, dev))
    step_ms = time_cuda(lambda: train_step(state, cam, gt, bg, lrs, SH_DEGREE), 5)
    say(f"[5 step] one training step at {model.num_alive} Gaussians, 800x800: {step_ms:.3f} ms; "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" ms (sum {sum(stages.values()):.3f} ms); C as one wrapper call {c_ms:.3f} ms; "
          f"D with dy {d_both_ms:.4f} ms, without (the step's call) {stages['D']:.4f} ms")
    profile_steps(lambda: train_step(state, cam, gt, bg, lrs, SH_DEGREE))
    return {"bargs": bargs, "img": img, "gt": gt, "cot": cot, "B": err_b, "C": err_c, "D": err_d,
            "c_ms": c_ms, "d_ms": d_both_ms, "stages": stages, "step_ms": step_ms}


def profile_steps(step, n: int = 5, label: str = "[5 profile]") -> None:
    """Device busy and idle share of `n` steps and the kernels that take
    the most device time, from torch.profiler. Prints "not measured" if
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        say(f"{label} device busy share: not measured (no device events recorded)")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    totals = {}
    for e in kernels:
        totals[e.name] = totals.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:8]
    say(f"{label} {n} steps: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
        f"({100 * busy / wall_us:.1f}%, idle {100 * (1 - busy / wall_us):.1f}%), "
        f"{len(kernels)} kernel launches ({len(kernels) / n:.0f} per step); top kernels by device ms: "
        + "; ".join(f"{name[:60]} {t / 1e3:.3f}" for name, t in top))


def phase_scratch(dev) -> None:
    argv = ["-s", FLAGSHIP_SCENE, "-m", SCRATCH_DIR, "--eval", "--iterations", SCRATCH_ITERS,
            "--densify_from_iter", 20, "--densification_interval", 25, "--densify_until_iter", 90,
            "--test_iterations", 10, SCRATCH_ITERS, "--save_iterations", SCRATCH_ITERS,
            "--checkpoint_iterations", SCRATCH_ITERS, "--device", dev.type]
    out = run_cli(train_main, argv)
    rows = [r.split("\t") for r in (SCRATCH_DIR / "losses.tsv").read_text().strip().splitlines()[1:]]
    (it0, l1_0, psnr_0, n_0), (it1, l1_1, psnr_1, n_1) = rows
    n_init = int(out.split("Number of points at initialisation : ")[1].split()[0])
    densified = [ln for ln in out.splitlines() if "densify:" in ln]
    nf = [ln for ln in out.splitlines() if ln.startswith("nonfinite_grads:")]
    if not float(l1_1) < float(l1_0):
        raise AssertionError(f"test L1 did not fall: {l1_0} at {it0}, {l1_1} at {it1}")
    if int(n_1) == n_init or not densified or not nf:
        raise AssertionError(f"no densify ({densified}), count {n_init} -> {n_1}, report {nf}")
    # full_eval.py's render argv
    run_cli(render_main, ["--iteration", SCRATCH_ITERS, "-s", FLAGSHIP_SCENE, "-m", SCRATCH_DIR,
                          "--quiet", "--eval", "--skip_train", "--device", dev.type])
    renders = sorted((SCRATCH_DIR / "test" / f"ours_{SCRATCH_ITERS}" / "renders").glob("*.png"))
    got = evaluate([str(SCRATCH_DIR)], device=dev)[str(SCRATCH_DIR)][f"ours_{SCRATCH_ITERS}"]
    if len(renders) != 8 or abs(got["PSNR"] - float(psnr_1)) > 0.5:
        raise AssertionError(f"{len(renders)} renders, PSNR {got['PSNR']} vs report {psnr_1}")
    say(f"[6 scratch] {SCRATCH_ITERS} iterations from {n_init} points: test L1 {float(l1_0):.5f} -> "
        f"{float(l1_1):.5f}, PSNR {float(psnr_0):.3f} -> {float(psnr_1):.3f}, Gaussians {n_0} -> {n_1}, "
        f"{len(densified)} densify steps; {nf[0]}; the saved PLY renders 8 views at "
        f"PSNR {got['PSNR']:.3f} (8-bit PNGs)")


def phase_timing(dev, errs: dict, launches: dict, views, step: dict) -> list:
    model = GaussianModel.from_ply(str(FLAGSHIP_PLY), SH_DEGREE, dev)
    bg = torch.zeros(3, device=dev)
    tot = {"inst": 0, "render": 0.0, "ssim": 0.0, "A": 0.0, "B": 0.0}
    first = None
    for i, v in enumerate(views):
        out = render(v.camera, model.render_inputs(SH_DEGREE), bg)
        gt = read_image(SMOKE_DIR / "test" / METHOD / "gt" / f"{i:05d}.png", dev)
        q = read_image(SMOKE_DIR / "test" / METHOD / "renders" / f"{i:05d}.png", dev)
        render_ms = time_cuda(lambda: eval_render(model, v.camera, bg, SH_DEGREE), 3)
        ssim_ms = time_cuda(lambda: ssim_ops.ssim(q, gt), 20)
        p = project_and_shade(v.camera, model.render_inputs(SH_DEGREE))
        w, h = v.camera.image_width, v.camera.image_height
        _, args = raster_inputs(p, w, h)
        a_ms = time_ms(lambda: flat_raster.rasterize_tiles(*args), 10)
        b_ms = time_ms(lambda: ssim_ops.ssim_forward(q, gt), 20)
        say(f"[7 timing] view {i}: {out['n_instances']} instances, render {render_ms:.3f} ms "
            f"(kernel A {a_ms:.3f}), ssim {ssim_ms:.3f} ms (kernel B {b_ms:.3f})")
        tot["inst"] += out["n_instances"]
        tot["render"] += render_ms
        tot["ssim"] += ssim_ms
        tot["A"] += a_ms
        tot["B"] += b_ms
        if first is None:
            first = {"args": args, "q": q, "gt": gt, "a_ms": a_ms, "b_ms": b_ms}
    say(f"[7 timing] total over {len(views)} views: {tot['inst']} instances, render {tot['render']:.3f} ms, "
        f"ssim {tot['ssim']:.3f} ms, kernel A {tot['A']:.3f} ms, kernel B {tot['B']:.3f} ms")

    # view 0 at the main path's shapes: kernel against plain, and the bounds
    args = first["args"]
    errs["A"] = max(errs["A"], compare_raster(args))
    t0 = time.perf_counter()
    _, _, n_contrib = flat_raster.rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    plain_a_ms = (time.perf_counter() - t0) * 1e3
    n = args[4].shape[0]
    m = args[2].shape[0]
    hw = args[5] * args[6]
    # point_list, the 48-byte records, tile ranges and schedule, 20 bytes out per pixel
    a_bytes = 4 * m + 4 * flat_raster.REC_WIDTH * n + 12 * args[0].shape[0] + 20 * hw
    a_bound, a_by = bound_ms(a_bytes, flat_raster.OPS_PER_PAIR * float(n_contrib.sum()))

    q, gt = first["q"], first["gt"]
    errs["B"] = max(errs["B"], compare_ssim(q, gt))
    plain_b_ms = time_cuda(lambda: ssim_ops.ssim_plain(q, gt), 5)
    w1d = ssim_ops.gaussian_window().to(dev)
    lib_b_ms = time_ms(lambda: conv2d_ssim(q, gt, w1d), 20)
    lib_err = abs(float(conv2d_ssim(q, gt, w1d)) - float(ssim_ops.ssim_plain(q, gt)))
    h, w = q.shape[1:]
    n_part = 3 * (-(-h // ssim_ops.TILE_H)) * (-(-w // ssim_ops.TILE_W))
    b_bound, b_by = bound_ms(2 * 4 * 3 * h * w + 2 * 4 * n_part + 4, ssim_ops.OPS_PER_PIXEL * 3 * h * w)

    # Kernels C and D on the training step's inputs (phase 5, view 0)
    bargs = step["bargs"]
    t0 = time.perf_counter()
    flat_raster.rasterize_tiles_backward_plain(*bargs)
    torch.cuda.synchronize()
    plain_c_ms = (time.perf_counter() - t0) * 1e3
    n, m = bargs[4].shape[0], bargs[2].shape[0]
    hw = bargs[5] * bargs[6]
    grad_bytes = 4 * flat_raster.N_GRADS
    # walk: point_list, perm, tile ranges and schedule, records, t_final,
    # n_contrib and dC per pixel, bg in; the instance gradients out.
    # Reduction: the instance gradients, rank starts and order in; the
    # Gaussian gradients out. C as a whole: the walk's inputs plus the
    # reduction's rank starts and order in, the Gaussian gradients out.
    walk_in = (12 * m + 12 * bargs[0].shape[0] + 4 * flat_raster.REC_WIDTH * n + 20 * hw + 12)
    walk_ops = flat_raster.OPS_PER_PAIR_BWD * float(bargs[8].sum())
    walk_bound = bound_ms(walk_in + grad_bytes * m, walk_ops)
    reduce_bound = bound_ms(grad_bytes * m + 8 * (n + 1) + 8 * n + grad_bytes * n,
                            flat_raster.N_GRADS * m)
    c_bound, c_by = bound_ms(walk_in + 8 * (n + 1) + 8 * n + grad_bytes * n, walk_ops)
    img, sgt, cot = step["img"], step["gt"], step["cot"]
    plain_d_ms = time_cuda(lambda: ssim_ops.ssim_backward_plain(img, sgt, cot), 3)
    xg = img.clone().requires_grad_(True)
    lib_out = conv2d_ssim(xg, sgt, w1d)
    lib_d_ms = time_ms(lambda: torch.autograd.grad(lib_out, xg, retain_graph=True), 20)
    d_bound, d_by = bound_ms(4 * 4 * 3 * hw + 4, ssim_ops.OPS_PER_PIXEL_BWD * 3 * hw)
    say(f"[7 timing] view 0: plain A {plain_a_ms:.3f} ms, plain B {plain_b_ms:.3f} ms, "
        f"conv2d SSIM {lib_b_ms:.3f} ms (|d| {lib_err:.2e}); kernel C {step['c_ms']:.3f} ms, "
        f"plain C {plain_c_ms:.3f} ms; kernel D {step['d_ms']:.3f} ms, plain D {plain_d_ms:.3f} ms, "
        f"conv2d SSIM backward {lib_d_ms:.3f} ms")
    # what the longest-first tile schedule buys: the same kernels with the
    # tiles handed to blocks in raster order (the same bits, phase 3)
    raster_order = torch.arange(args[3].shape[0], dtype=torch.int32, device=dev)
    a_raster = (*args[:3], raster_order, *args[4:])
    c_raster = (*bargs[:3], raster_order, *bargs[4:])
    inst = torch.empty((m, flat_raster.N_GRADS), device=dev)
    order_ms = {"A": time_ms(lambda: flat_raster.rasterize_tiles(*args), 20),
                "A raster order": time_ms(lambda: flat_raster.rasterize_tiles(*a_raster), 20),
                "C walk": time_ms(lambda: flat_raster.raster_backward_walk(bargs, inst), 20),
                "C walk raster order": time_ms(lambda: flat_raster.raster_backward_walk(c_raster, inst), 20)}
    say("[7 timing] view 0, tile order: " + ", ".join(f"{k} {v:.4f} ms" for k, v in order_ms.items()))
    st = step["stages"]
    say(f"[7 timing] view 0, kernel C apart: walk {st['C walk']:.4f} ms (bound {walk_bound[0]:.4f} ms, "
        f"{walk_bound[1]}), reduction {st['C reduction']:.4f} ms (bound {reduce_bound[0]:.4f} ms, "
        f"{reduce_bound[1]}); {m} instances, {n} depth ranks, "
        f"{int((bargs[12][1:] == bargs[12][:-1]).sum())} empty runs, longest run "
        f"{int((bargs[12][1:] - bargs[12][:-1]).max())}, "
        f"{float(bargs[8].sum()):.0f} instance-pixel pairs below n_contrib")
    return [
        {"name": "flat_raster_forward", "route": "cuda", "source": "sgs_tpu_torch/csrc/flat_raster.cu",
         "replaces": "sgs_tpu/ops/pallas/flat_raster.py:462", "launches": launches["A"],
         "max_abs_err": errs["A"], "ms": first["a_ms"], "plain_ms": plain_a_ms,
         "bound_ms": a_bound, "bound_by": a_by, "library_ms": None},
        {"name": "ssim_forward", "route": "cuda", "source": "sgs_tpu_torch/csrc/ssim.cu",
         "replaces": "sgs_tpu/ops/pallas/ssim_kernels.py:228", "launches": launches["B"],
         "max_abs_err": errs["B"], "ms": first["b_ms"], "plain_ms": plain_b_ms,
         "bound_ms": b_bound, "bound_by": b_by, "library_ms": lib_b_ms},
        {"name": "flat_raster_backward", "route": "cuda",
         "source": "sgs_tpu_torch/csrc/flat_raster_backward.cu",
         "replaces": "sgs_tpu/ops/pallas/flat_raster.py:744", "launches": launches["C"],
         "max_abs_err": errs["C"], "ms": step["c_ms"], "plain_ms": plain_c_ms,
         "bound_ms": c_bound, "bound_by": c_by, "library_ms": None},
        {"name": "ssim_backward", "route": "cuda", "source": "sgs_tpu_torch/csrc/ssim_backward.cu",
         "replaces": "sgs_tpu/ops/pallas/ssim_kernels.py:254", "launches": launches["D"],
         "max_abs_err": errs["D"], "ms": step["d_ms"], "plain_ms": plain_d_ms,
         "bound_ms": d_bound, "bound_by": d_by, "library_ms": lib_d_ms},
    ]


# Non-ablation variants against Kernel A at 1080p: the bar of the
# package's images (3e-5) on colours and t_final and equal last_contrib,
# off the pixels at a cut (`exp_forward.near_cut`), which must stay under
# 1% of the compared pixels.
EXP_ATOL, NEAR_CUT_SHARE = 3e-5, 0.01


def alpha_against_old(sc: dict, dev, old_alpha) -> list:
    """F alpha at the CLI's (krows, out_cols) on the scene `sc`: the
    committed kernel and `old_alpha` (PR 10's alpha path, built from
    `scan_ablation`'s variant) give the same bits, and are timed in turns
    (committed, old, old, committed, twice over); medians."""
    out = []
    for krows, out_cols in ((8, 8), (8, 1), (32, 1)):
        fn = scan_ablation.runner(sc, "F", "alpha", krows, out_cols)
        if not torch.equal(scan_ablation.with_kernel(old_alpha, fn), fn()):
            raise AssertionError(f"F alpha krows {krows} out_cols {out_cols}: PR 10's path gives other bits")
        new_ms, old_ms = [], []
        for _ in range(2):
            new_ms.append(time_ms(fn, 20))
            old_ms += [scan_ablation.time_with(old_alpha, fn, dev) for _ in range(2)]
            new_ms.append(time_ms(fn, 20))
        out.append({"krows": krows, "out_cols": out_cols, "ms": float(np.median(new_ms)),
                    "pr10_ms": float(np.median(old_ms))})
    return out


def phase_experiments(dev, errs: dict, old_alpha) -> list:
    """The forward-raster experiments at 1920x1080 with 100,000 Gaussians:
    the scene built once and the three CLIs run on it, with the launch
    counts reset before and read after, every variant held to Kernel A;
    then E, F and G in every mode and krows against their plain versions
    on the same rows, F alpha against PR 10's alpha path (`old_alpha`),
    and each kernel's bound (`tools/exp_bounds.py`)."""
    reset_counts()
    t0 = time.perf_counter()
    sc = exp_scene.build_scene(device=dev)
    exp_scene.describe(sc, 0)
    say(f"[8 experiments] scene digest {exp_scene.digest(sc)} (packed rows, tile rows, schedule)")
    ref, near = exp_scene.references(sc)
    res_e = exp_fwd.run(sc, dev, ref, near)
    res_f = exp_fwd2.run(sc, dev)
    res_g = exp_transposed.run(sc, dev, ref, near)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    if (min(launches[k] for k in "EFG") == 0 or launches["B"] or launches["C"] or launches["D"]
            or any(launches[k] for k in "HIJK")):
        raise AssertionError(f"experiment launches {launches}")
    n_pix = int(((sc["n_chunks"] > 0)[:, None] & ~torch.isnan(ref[1])).sum())
    for r in res_e + res_g:
        err = r.get("err")
        if err is None:
            continue
        if (err["color"] > EXP_ATOL or err["t_final"] > EXP_ATOL or err["last_contrib"] != 0
                or err["near_cut_pixels"] > NEAR_CUT_SHARE * n_pix):
            raise AssertionError(f"Kernel {r['kernel']} {r['mode']} krows {r['krows']} against "
                                 f"Kernel A: {err} ({n_pix} pixels compared)")
    say(f"[8 experiments] 1080p scene and CLIs: launches {launches}, {wall:.2f} s; every variant "
        f"within {EXP_ATOL} of Kernel A (last_contrib equal) on {n_pix} pixels of non-empty tiles, "
        f"{res_e[1]['err']['near_cut_pixels']} pixels at a cut left out")

    # the same rows: kernels against plain versions, and the bounds
    e = compare_experiments(sc, exp_forward.KROWS, near)
    for k in "EFG":
        errs[k] = max(errs[k], e[k])
    for k, v in mxu_thrice(sc, near).items():
        errs[k] = max(errs[k], v)
    crs, nch, sched, tx = sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"]
    fm, im = sc["packed_fm"], sc["packed"]
    t1 = time.perf_counter()
    _, info = exp_forward.scan_plain(fm, crs, nch, tx, "hs")
    torch.cuda.synchronize()
    plain = {"E": (time.perf_counter() - t1) * 1e3}
    plain["F"] = time_cuda(lambda: exp_forward.ablation_rows_plain(fm, crs, nch, sched, tx), 1)
    plain["G"] = time_cuda(lambda: exp_forward.transposed_rows_plain(im, crs, nch, sched, tx), 1)
    # the scans need only the rows the hs scan walks; F's alpha walks every row
    walked, every = exp_bounds.scene_counts(sc, info["walked"]), exp_bounds.scene_counts(sc)
    where = {"E": ("exp_forward E (hs, krows 8)", "scripts/exp_fwd.py:210", walked, "hs"),
             "E mxu": ("exp_forward E (mxu)", "scripts/exp_fwd.py:210", walked, "mxu"),
             "F": ("exp_forward F (alpha, krows 8, out_cols 8)", "scripts/exp_fwd2.py:84", every, "alpha"),
             "G": ("exp_forward G (hs, krows 8)", "scripts/exp_transposed.py:147", walked, "hs")}
    bounds = {k: exp_bounds.forward(v[1], v[0], v[2], v[3]) for k, v in where.items()}
    # Kernel A on the same bins, for the comparison: its bound as in phase 7
    ka = sc["kernel_a"]
    _, _, n_contrib = flat_raster.rasterize_tiles(*ka)
    a_bound = bound_ms(4 * ka[2].shape[0] + 4 * flat_raster.REC_WIDTH * ka[4].shape[0]
                       + 12 * sc["num_tiles"] + 20 * ka[5] * ka[6],
                       flat_raster.OPS_PER_PAIR * float(n_contrib.sum()))
    say(f"[8 experiments] Kernel A on the 1080p bins: {exp_scene.fmt_ms(res_e[0]['ms'])}, bound {a_bound[0]:.4f} ms "
        f"({a_bound[1]}), {float(n_contrib.sum()):.0f} instance-pixel pairs below n_contrib")
    ms = {"E": res_e[1]["ms"], "F": next(x["ms"] for x in res_f if x.get("mode") == "alpha"),
          "G": res_g[1]["ms"]}
    dead = exp_forward.dead_warps(exp_forward.forward_rows(fm, crs, nch, sched, tx, "hs"), sc["row_first"],
                                  sc["row_tile"], sc["num_tiles"])
    say(f"[8 experiments] walked warps without a live pixel (hs forms only their t_run): "
        f"{dead['dead_warps']} of {dead['warps_walked']} ({dead['dead_warps'] / dead['warps_walked']:.4f})")
    far = exp_forward.far_records(fm, sc["row_tile"], tx, sc["num_tiles"])
    say(f"[8 experiments] F alpha: (row, slot, warp) triples whose exp the warp skips {far['far']} of "
        f"{far['slot_warps']} ({far['share']:.4f}); device ms, this design against PR 10's alpha path "
        f"in turns (medians, the same bits): "
        + ", ".join(f"krows {a['krows']} out_cols {a['out_cols']} {a['ms']:.4f} (PR 10 {a['pr10_ms']:.4f})"
                    for a in alpha_against_old(sc, dev, old_alpha)))
    say(f"[8 experiments] kernels against plain versions on the 1080p rows (krows "
        f"{' and '.join(map(str, exp_forward.KROWS))}, every mode): E, G hs/nocp and F bit for bit, "
        f"mxu max |err| E {e['E']:.2e} G {e['G']:.2e}; {walked['read']} of {sc['rows_used']} rows "
        f"walked (hs), pairs walked {walked['P']}, all {every['P']}; bounds (ms) "
        + ", ".join(f"{k} {b['bound_ms']:.4f} ({b['bound_by']}, {b['bytes']} B, {b['ops']} f32 ops)"
                    for k, b in bounds.items())
        + "; plain ms " + ", ".join(f"{k} {v:.1f}" for k, v in plain.items())
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return [{"name": where[k][0], "route": "cuda", "source": "sgs_tpu_torch/csrc/exp_forward.cu",
             "replaces": where[k][1], "launches": launches[k], "max_abs_err": errs[k], "ms": ms[k],
             "plain_ms": plain[k], "bound_ms": bounds[k]["bound_ms"], "bound_by": bounds[k]["bound_by"],
             "library_ms": None} for k in "EFG"]


def phase_gather(dev, errs: dict) -> list:
    """The gather experiments at the scripts' sizes: the three CLIs run in
    this process with the launch counts reset before and read after; then
    H-K against their plain versions on the same inputs, the plain
    versions' and the library calls' ms, and the bounds."""
    reset_counts()
    t0 = time.perf_counter()
    vm = exp_vmem_gather.run(dev)
    dm = exp_dma_gather.run(dev)
    lay = exp_gather_layout.run(dev)
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    if min(launches[k] for k in "HIJK") == 0 or any(launches[k] for k in "ABCDEFG"):
        raise AssertionError(f"gather launches {launches}")
    say(f"[9 gather] CLIs at the scripts' sizes: launches {launches}, {wall:.2f} s; the scripts' own "
        f"checks: ok={vm['ok']}, A == B: {bool(torch.allclose(dm['a'], dm['b'], rtol=1e-5))} "
        f"(False by design: the last grid step's sum against the sum over every row)")

    table, ids, attr, starts, packed = vm["table"], vm["ids"], dm["attr"], dm["starts"], dm["packed"]
    fm16 = lay["widths"][16]["field_major"]
    cases = gather_cases(table, ids, attr, starts, packed) + [
        ("K", lambda: gather.layout_identity(fm16), lambda: gather.layout_identity_plain(fm16))]
    plain, want = {}, {}
    for name, run, plain_fn in cases:
        want[name] = plain_fn()
        check_equal(name, run, want[name])
        errs[name] = 0.0
        plain[name] = time_cuda(plain_fn, 3)
    for rec in gather.WIDTHS:
        x = lay["tables"][rec]
        for src in (x, lay["widths"][rec]["field_major"]):
            check_equal(f"K {gather.layout(src)} ({rec} lanes)", lambda: gather.layout_identity(src), x)

    # one PyTorch call each for the same function (timed only)
    fn = torch.nn.functional
    steps = ids.numel() // (gather.KROWS * gather.CHUNK)
    bags = ids[: steps * gather.KROWS * gather.CHUNK].view(steps, gather.KROWS, gather.CHUNK)
    bags = bags.transpose(1, 2).reshape(-1, gather.KROWS)
    rows = starts.numel() // gather.KROWS * gather.KROWS
    windows = starts[None, :rows].long() + torch.arange(gather.CHUNK, device=dev)[:, None]
    steps_i = packed.shape[0] // (gather.KROWS * gather.CHUNK)
    pk = packed[: steps_i * gather.KROWS * gather.CHUNK].view(steps_i, gather.KROWS, gather.CHUNK, gather.REC)
    library = {"H": lambda: fn.embedding_bag(bags, table, mode="sum"),
               "I": lambda: pk.sum(1).mul_(2.0),
               "J": lambda: fn.embedding_bag(windows, attr, mode="sum").mul_(2.0),
               "K": lambda: fm16.contiguous()}
    lib_ms = {k: time_ms(f, 20) for k, f in library.items()}
    lib_err = {k: float((f().view_as(want[k]) - want[k]).abs().max()) for k, f in library.items()}
    l2 = l2_rate.l2_read_rate(dev)
    bounds = dict(zip("HIJK", exp_bounds.gather_rows((table, ids), (attr, starts), fm16.shape[0],
                                                     l2["bytes_per_s"])))
    ms = {"H": vm["ms"], "I": dm["a_ms"], "J": dm["b_ms"], "K": lay["widths"][16]["ident_ms"]}
    h = bounds["H"]
    say(f"[9 gather] L2 read rate {l2['bytes_per_s'] / 1e12:.4f} TB/s (`tools/l2_rate.py`: "
        f"{l2['bytes']} B from a {l2['buffer_bytes']} B buffer in {l2['ms']:.4f} ms; {l2['card']}); "
        f"Kernel H's bound restated: its HBM bytes {h['hbm_bound_ms']:.4f} ms, its {h['l2_bytes']} B "
        f"of record reads at that rate {h['l2_ms']:.4f} ms, so {h['bound_ms']:.4f} ms ({h['bound_term']}); "
        f"H {ms['H']:.4f} ms reaches {h['bound_ms'] / ms['H']:.1%} of it")
    say("[9 gather] kernels against plain versions at the scripts' sizes (H every step's sum, K from "
        "both layouts at 16 and 8 lanes): bit for bit, repeatable; "
        + ", ".join(f"{k} {ms[k]:.4f} ms (bound {bounds[k]['bound_ms']:.4f}, {bounds[k]['bound_by']}, "
                    f"{bounds[k]['bytes']} B; plain {plain[k]:.3f} ms; library {lib_ms[k]:.4f} ms, "
                    f"|d| {lib_err[k]:.2e})" for k in "HIJK")
        + f"; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    names = {"H": ("gather H (vector gather from a table)", "scripts/exp_vmem_gather.py:46"),
             "I": ("gather I (pipeline over the packed gather)", "scripts/exp_dma_gather.py:62"),
             "J": ("gather J (window DMA, summed over every row)", "scripts/exp_dma_gather.py:117"),
             "K": ("gather K (identity, field-major to row-major, 16 lanes)", "scripts/exp_gather_layout.py:39")}
    return [{"name": names[k][0], "route": "cuda", "source": "sgs_tpu_torch/csrc/gather.cu",
             "replaces": names[k][1], "launches": launches[k], "max_abs_err": errs[k], "ms": ms[k],
             "plain_ms": plain[k], "bound_ms": bounds[k]["bound_ms"], "bound_by": bounds[k]["bound_by"],
             "library_ms": lib_ms[k]} for k in "HIJK"]


def phase_lgm_render(dev) -> None:
    """(a) The committed LGM snapshot through the render and metrics CLIs,
    held per view to the JAX package's numbers."""
    per_view = json.loads(LGM_PER_VIEW.read_text())[LGM_METHOD]
    # runs/lgm_r5/cfg_args, with this checkout's paths
    save_cfg_args(str(LGM_RENDER_DIR), ModelParams(
        sh_degree=0, source_path=str(LGM_SCENE), model_path=str(LGM_RENDER_DIR),
        white_background=False, eval=True))
    reset_counts()
    t0 = time.perf_counter()
    run_cli(render_main, ["-m", LGM_RENDER_DIR, "--ply", LGM_PLY, "--sh_degree", 0,
                          "--iteration", 3000, "--skip_train", "--device", dev.type])
    run_cli(metrics_main, ["-m", LGM_RENDER_DIR, "--device", dev.type])
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    mine = json.loads((LGM_RENDER_DIR / "per_view.json").read_text())[LGM_METHOD]
    names = sorted(per_view["PSNR"])
    if sorted(mine["PSNR"]) != names:
        raise AssertionError(f"rendered views {sorted(mine['PSNR'])} != {names}")
    failures = []
    for name in names:
        dp = mine["PSNR"][name] - per_view["PSNR"][name]
        ds = mine["SSIM"][name] - per_view["SSIM"][name]
        say(f"[10 lgm] snapshot {name}: PSNR {mine['PSNR'][name]:.4f} (JAX {per_view['PSNR'][name]:.4f}, "
            f"d {dp:+.5f}) SSIM {mine['SSIM'][name]:.6f} (JAX {per_view['SSIM'][name]:.6f}, d {ds:+.2e})")
        if abs(dp) > PSNR_BAR or abs(ds) > SSIM_BAR:
            failures.append(name)
    got = json.loads((LGM_RENDER_DIR / "results.json").read_text())[LGM_METHOD]
    results = json.loads(LGM_RESULTS.read_text())[LGM_METHOD]
    say(f"[10 lgm] snapshot mean: PSNR {got['PSNR']:.7f} (JAX {results['PSNR']:.7f}, "
        f"d {got['PSNR'] - results['PSNR']:+.2e}) SSIM {got['SSIM']:.7f} (JAX {results['SSIM']:.7f}, "
        f"d {got['SSIM'] - results['SSIM']:+.2e}); launches A {launches['A']} B {launches['B']}; "
        f"render+metrics CLIs {wall:.2f} s")
    if failures:
        raise AssertionError(f"LGM views off the JAX numbers: {failures}")
    if launches != only(A=len(names), B=len(names)):
        raise AssertionError(f"LGM render launches {launches}, expected A and B {len(names)}")


def lgm_init(dev):
    """The train_lgm CLI's init on data/lgm400: (scene, model). The CLI
    seeds `random`, `numpy` and `torch` with 0 before the Scene draws its
    2,000 points; the trainer's generator is seeded with 0."""
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)
    dataset = ModelParams(sh_degree=0, source_path=str(LGM_SCENE), model_path="", eval=True)
    with contextlib.redirect_stdout(io.StringIO()):
        scene = Scene(dataset, device=dev, downsample_init=LGM_DOWNSAMPLE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = LatentGaussianModel.create(gen, np.zeros((1, 3), np.float32), device=dev)
    model.create_from_pcd(gen, scene.init_pcd.points, scene.init_pcd.colors)
    return scene, model


def lgm_kernel_ms(label, model, cam, gt, bg) -> dict:
    """Kernels A-D's device ms on one LGM view."""
    with torch.no_grad():
        inputs = model.render_inputs(0)
    _, args, bargs, img, cot = step_kernel_inputs(inputs, cam, gt, bg)
    ms = {"A": time_ms(lambda: flat_raster.rasterize_tiles(*args), 10),
          "B": time_ms(lambda: ssim_ops.ssim_forward(img, gt), 20),
          "C": time_ms(lambda: flat_raster.rasterize_tiles_backward(*bargs), 10),
          "D": time_ms(lambda: ssim_ops.ssim_backward(img, gt, cot, with_dy=False), 20)}
    runs = bargs[12]
    say(f"[10 lgm] {label}: {bargs[2].shape[0]} instances, longest tile list "
        f"{int((args[1] - args[0]).max())}, longest run {int((runs[1:] - runs[:-1]).max())}; device ms "
        + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()))
    return ms


def lgm_image_and_grads(model, cam, gt, bg):
    _, _, grads, out = lgm_trainer.lgm_grads(model, cam, gt, bg, 0.2, 0)
    return out["render"].detach(), grads


def phase_lgm_step(dev) -> None:
    """(b) One full-width LGM step from the port's seeded init: Kernels A
    and C against their plain versions bit for bit on the step's inputs,
    the image and every leaf's gradient through the kernels against the
    plain path's, then the step split into its stages."""
    scene, model = lgm_init(dev)
    view = scene.getTrainCameras()[0]
    cam, gt = view.camera, view.gt_image
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        inputs = model.render_inputs(0)
    _, args, bargs, _, _ = step_kernel_inputs(inputs, cam, gt, bg)
    compare_raster(args)
    compare_raster_backward(bargs)
    image, got = lgm_image_and_grads(model, cam, gt, bg)
    with plain_path():
        want_image, want = lgm_image_and_grads(model, cam, gt, bg)
    torch.cuda.synchronize()
    img_err = float((image - want_image).abs().max())
    if not img_err <= LGM_IMAGE_ATOL:
        raise AssertionError(f"LGM image through the kernels differs from the plain path: {img_err}")
    worst = {k.split("/", 1)[-1]: v for k, v in check_grads(got, want).items()}
    say(f"[10 lgm] step at init ({model.num_structures} structures, {model.num_gaussians} Gaussians, "
        f"400x400, train view 0): A and C equal their plain versions bit for bit; image max |err| "
        f"{img_err:.2e} (bar {LGM_IMAGE_ATOL}); gradients max |err| / leaf max: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
        + f" (rtol {GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x max)")
    lgm_kernel_ms("iteration 1 (init)", model, cam, gt, bg)

    # the step's stages, host included (CUDA events, means over the reps):
    # decode (the MLP, the composition and the activations), render and
    # loss from decoded inputs, the backward through everything, Adam
    params = model.trainable_params()
    stages = {"decode": time_cuda(lambda: model.render_inputs(0), 10)}
    inputs = model.render_inputs(0)
    stages["render+loss"] = time_cuda(
        lambda: ssim_ops.training_loss(render(cam, inputs, bg)["render"], gt, 0.2), 10)
    loss = ssim_ops.training_loss(render(cam, inputs, bg)["render"], gt, 0.2)
    stages["backward"] = time_cuda(
        lambda: torch.autograd.grad(loss, list(params.values()), retain_graph=True), 10)
    adam = TreeAdamState.init(params)
    stages["Adam"] = time_cuda(
        lambda: adam_tree_update(params, got, adam, lgm_trainer.LGM_LR, eps=lgm_trainer.LGM_EPS), 10)
    state = {"adam": adam}

    def step():
        state["adam"], _ = lgm_trainer.lgm_train_step(model, state["adam"], cam, gt, bg, 0.2, 0)

    step_ms = time_cuda(step, 10)
    say(f"[10 lgm] one step at init: {step_ms:.3f} ms; "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" ms (sum {sum(stages.values()):.3f} ms)")
    profile_steps(step, label="[10 lgm profile]")


def phase_lgm_train(dev) -> None:
    """(c) `python -m sgs_tpu_torch.train_lgm` from scratch, then A-D on
    its checkpoints."""
    argv = ["-s", LGM_SCENE, "-m", LGM_TRAIN_DIR, "--eval", "--iterations", LGM_ITERS,
            "--downsample_init", LGM_DOWNSAMPLE, "--sh_degree", 0,
            "--test_iterations", *LGM_TESTS, "--save_iterations", LGM_ITERS,
            "--checkpoint_iterations", LGM_TESTS[0], LGM_ITERS, "--device", dev.type]
    reset_counts()
    t0 = time.perf_counter()
    out = run_cli(train_lgm_main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    reports = {}
    for ln in out.splitlines():
        if "Evaluating" in ln:
            it = int(ln.split("[ITER ")[1].split("]")[0])
            reports[(ln.split("Evaluating ")[1].split(":")[0], it)] = float(ln.split("PSNR ")[1])
    n_views = len(json.loads((LGM_SCENE / "transforms_test.json").read_text())["frames"]) + 8
    steps = LGM_ITERS
    rate = [ln for ln in out.splitlines() if ln.startswith("LGM: ")]
    for it in LGM_TESTS:
        say(f"[10 lgm] from scratch, iteration {it}: test PSNR {reports[('test', it)]:.4f} "
            f"(JAX {JAX_LGM_TEST_PSNR[it]:.4f}, d {reports[('test', it)] - JAX_LGM_TEST_PSNR[it]:+.4f}), "
            f"train[:8] PSNR {reports[('train', it)]:.4f} (JAX {JAX_LGM_TRAIN_PSNR[it]:.4f}, "
            f"d {reports[('train', it)] - JAX_LGM_TRAIN_PSNR[it]:+.4f})")
    say(f"[10 lgm] from scratch: {rate[0] if rate else 'no rate line'}; trainer call {wall:.2f} s "
        f"(scene load and reports included); launches {launches}")
    first, last = reports[("test", LGM_TESTS[0])], reports[("test", LGM_ITERS)]
    if not last > first:
        raise AssertionError(f"LGM test PSNR did not rise: {first} at {LGM_TESTS[0]}, {last} at {LGM_ITERS}")
    if last < JAX_LGM_TEST_PSNR[LGM_ITERS] - LGM_PSNR_BAR:
        raise AssertionError(f"LGM test PSNR {last} at {LGM_ITERS} is more than {LGM_PSNR_BAR} dB "
                             f"below JAX's {JAX_LGM_TEST_PSNR[LGM_ITERS]}")
    if launches != only(A=steps + len(LGM_TESTS) * n_views, B=steps, C=steps, D=steps):
        raise AssertionError(f"LGM training launches {launches}, expected A {steps} + "
                             f"{len(LGM_TESTS)} x {n_views}, B, C and D {steps}")
    if not (LGM_TRAIN_DIR / "point_cloud" / f"iteration_{LGM_ITERS}" / "point_cloud.ply").exists():
        raise AssertionError("train_lgm wrote no snapshot")

    scene, model = lgm_init(dev)
    view = scene.getTrainCameras()[0]
    bg = torch.zeros(3, device=dev)
    for it in (LGM_TESTS[0], LGM_ITERS):
        lgm_trainer.load_lgm_checkpoint(str(LGM_TRAIN_DIR / f"chkpnt{it}.npz"), model)
        lgm_kernel_ms(f"iteration {it}", model, view.camera, view.gt_image, bg)


def main(device: str = "cuda") -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device(device)
    old_alpha = phase_build()
    errs = phase_kernels(dev)
    phase_slice(dev)
    model = flagship_model(dev)
    train = phase_train_flagship(dev, model)
    views = read_nerf_synthetic_split(str(FLAGSHIP_SCENE), "test", WHITE_BACKGROUND, -1, dev)
    step = phase_step(dev, model, views[0])
    errs["B"] = max(errs["B"], step["B"])
    errs["C"] = max(errs["C"], step["C"])
    errs["D"] = max(errs["D"], step["D"])
    phase_scratch(dev)
    kernels = phase_timing(dev, errs, train["launches"], views, step)
    kernels += phase_experiments(dev, errs, old_alpha)
    kernels += phase_gather(dev, errs)
    phase_lgm_render(dev)
    phase_lgm_step(dev)
    phase_lgm_train(dev)
    say(f"[11 done] chip_smoke wall {time.perf_counter() - t_start:.2f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
