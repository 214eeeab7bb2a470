#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sgs_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: the six CUDA sources built cold from `sgs_tpu_torch/csrc/`,
     with the JPEG decoder's host library (`csrc/jpeg.cu`), the L2 read
     probe (`csrc/l2_read.cu`) and Kernel F's PR 10 alpha path
     (`tools/scan_ablation.py`'s `alpha_pr10` variant of
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
 11. the scene readers (`tools/colmap_scene.py` writes the scenes):
     (a) data/flagship800 as COLMAP, binary and text: 56 cameras, 49 train
     and 7 test, each camera within 1e-6 and each GT equal to the Blender
     form's, every view's PSNR of the trained flagship within 1e-4 dB of
     the Blender form's, then the render and metrics CLIs with
     `full_eval.py`'s argv on the copy's test split; (b) the same CLIs at
     -r 2 (400x400 GT through `data/resize.py`); both held per view to the
     JAX package's render.py and metrics.py on the same copy
     (`JAX_COLMAP_PSNR`, `JAX_COLMAP_SSIM`); (c) a COLMAP capture of the flagship at
     2000x1500 (24 of flagship800's train poses, its 20,000 points)
     through `python -m sgs_tpu_torch.train` from scratch for 100
     iterations: 1600x1200 cameras, the test L1 falling, the count
     changing, the scene's load time, one step and A-D's device ms at
     1600x1200; (d) a Zero123 scene of the flagship (12 RGBA views at
     256x256, a GLB of 16,000 faces) through the training CLI with
     `python -m sgs_tpu_torch.train_zero123`'s argv for 30 iterations:
     xyz stays the init's bit for bit. The launch counts are reset before
     and read after each run: A-D once a step, A also once per report
     view, A and B once per view of the render and metrics CLIs; the
     flagship's PNGs are decoded once for (a)'s Blender form and both
     COLMAP copies;
 12. the evaluation chain: (a) `python -m sgs_tpu_torch.get_psnr` on the
     committed LGM snapshot over all 56 views of data/lgm400, through the
     `.npy` that the port's `vectorized` writes and the npz that its
     checkpoint writer writes, each held to the JAX package's get_psnr.py
     on the same inputs (`JAX_GET_PSNR`, runs/get_psnr_lgm400_jax/) within
     1e-6 L1 and 1e-3 dB, test and train; it renders with the oracle and
     launches no kernel; (b) the oracle (`render(mode="reference")`)
     against Kernel A on flagship test views 0 and 1 and the LGM's 8 test
     views: within 3e-5 at every pixel but those that
     `tools/oracle_times.py::explain_pixels` accounts for by JAX's two
     f32 arrangements of the quadratic form (under 1% of the pixels), and
     the oracle's ms per view beside A's; (c) the render CLI with
     `--rasterizer reference`, then the metrics CLI, on the LGM snapshot,
     held per view to assets/lgm/per_view.json; (e) `python -m
     sgs_tpu_torch.full_eval --skip_training --skip_rendering` as a
     subprocess over the model directories of phases 4 and 10, whose
     results.json must not change; (d) LPIPS through the metrics CLI with
     seeded synthetic weights on phase 4's renders, one view against the
     CPU within rtol 1e-4, and ms per 800x800 pair; (f)
     `training_report(full_train_set=True, mode="tiled")` on the LGM
     snapshot: A once per view, B never, within 1e-4 dB of (a)'s oracle
     numbers. The launch counts are reset before and read after each run;
 13. the JPEG decoder and the tools: (a) every committed case of
     data/jpeg_cases, baseline and progressive (the block-smoothed ones
     counted, at least one required), through the native decoder
     (`ops/jpeg.py`, host C++ built with nvcc) equal to PIL's digest in
     digests.json, and to the plain decoder under 64,000 pixels; native
     ms per Mpx on the 800x800 views and the 4946x3286 frame, baseline
     and progressive, with the host's CPU model; (b) the
     JPEG COLMAP flagship (data/colmap_flagship800_jpg, 56 views, llffhold
     8): its scene load beside phase 11's PNG copy, the render and metrics
     CLIs held per view to the JAX package's numbers on it (`JAX_JPG_*`,
     within PSNR_BAR and SSIM_BAR), 100 iterations from points3d through
     A-D (launches equal to the steps and report views, the test L1
     falling), and the 4946x3286 frame's 1.6K GT through `-r -1` equal to
     the plain resize of the same decode; (c) `python -m
     sgs_tpu_torch.train_lgm` with the viewer listening on a free port: a
     client thread holds the loop (train=0), takes two frames and releases
     it with a third; each served frame equals `image_to_bytes` of the
     trainer's render of the same camera and scaling modifier, the run
     ends, and its step time with the listener open and no client is
     printed beside phase 10's; (d) `python -m sgs_tpu_torch.view` on the
     flagship: 24 frames at 512x512, Kernel A launched 24 times, each frame
     the quantised Kernel A render and within 3e-5 of the plain render,
     the GIF's header, frame count, delays and loop field; (e)
     `make_raytraced_dataset` regenerating data/lgm400 (each PNG equal to
     the committed one but for 1-LSB flips on under 0.1% of the pixels,
     points3d.ply within 1e-6), then `make_blender_dataset` at 128x128
     through the oracle and 200 training iterations on it; (f) `python -m
     sgs_tpu_torch.analyze_model` on the flagship printing the JAX CLI's
     lines, its PCA PLYs reloading. The launch counts are reset before and
     read after each run;
 14. multi-device training (`sgs_tpu_torch/parallel/`), on the flagship
     test view 0 at 800x800 with the model of phase 5: (a) the view as 8
     row bands on this card (`tile_shard.render_band` through
     `hybrid.render_bands`), equal (112 px) and balanced
     (`row_load_histogram`, `balanced_band_offsets`, the ownership cull and
     compaction), each band composited by Kernel A and differentiated by
     Kernel C (launches counted: once a band), stitched: the image within
     3e-5 of the full Kernel A render, the parameter and tap gradients
     within rtol 2e-3, atol 3e-6 of the full Kernel C step; each band's A
     and C device ms, on the arguments the checked render gave them,
     against the full frame's; (b) a one-rank NCCL group in
     this process: one `make_dp_train_step` and one 1x1
     `make_hybrid_train_step` (compacted) on the view against `train_step`
     at tests/test_torch_train_step.py's bars (new parameters, Adam
     moments, statistics, loss, nonfinite_grads), A-D once each a step;
     (c) `torchrun --nproc_per_node=1 -m sgs_tpu_torch.train --parallel
     dp` for 40 iterations from points3d.ply through one densify against
     `--parallel none` with the same seed: the same losses.tsv rows (rtol
     1e-4, the count exactly). With two cards or more (c) also runs dp and
     hybrid on every card; with one, the script says that branch did not
     run;
 15. the tiled rasterizer without tight culling (`--no-tight_culling`,
     rect binning) on flagship test view 0 with phase 5's model: (a) the
     view rendered with both binnings, the rect image within 3e-5 of the
     tight one, each binning's instance count and A's and C's device ms on
     its arguments; (b) 10 steps of the train CLI with --no-tight_culling
     from phase 5's checkpoint, A-D once a step, the snapshot's fields
     beside phase 5's;
 16. the benchmarks' path at 1920x1080 (`python -m sgs_tpu_torch.bench`,
     `python -m sgs_tpu_torch.tools.bench_scale`): (a) the flagship with
     bench.py's framing through `bench.measure` (10 forward+backward steps
     of the L1 loss and 10 renders, each after a warm-up; A 22 and C 11
     launches), the render-only image equal to the forward+backward image
     bit for bit, A and C against their plain versions over the whole frame
     bit for bit, frames/s and peak memory; (b) the 5M-Gaussian panning
     capture (BASELINE's garden scale): two forward+backward calls with a
     finite loss and gradients, the same bits in both, A and C against
     their plain versions on the 8 longest tile lists and 8 seeded draws
     (every other list emptied), bit for bit; in both the binning's counts
     (and the 5M pool's all-visible view's) against JAX's
     (`JAX_BENCH_COUNTS`, from tests/bench_counts.py) within 1e-5, the
     longest list, A's and C's device ms against their bounds, the
     forward+backward split into stages and its device busy share;
 17. a `{"kernels": [...]}` line (A-D also with `readers_launches`, their
     launches over phase 11, `tools_launches`, theirs over phase 13,
     `parallel_launches`, theirs over phase 14 (a) and (b),
     `rect_launches`, theirs over phase 15, A and B with
     `eval_launches`, theirs over phase 12, and A and C with
     `bench_launches`, theirs over phase 16), the device line, and
     last the result line `{"ok": true, "device": {...}}`.

Any failed phase raises and the script exits nonzero. It needs the
repository around it and a CUDA device; without either it fails before
printing a result.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import random
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.core.projection import TILE, tile_rect
from sgs_tpu_torch.data.ply import load_gaussian_ply, load_point_cloud_ply
from sgs_tpu_torch.data import jpeg as jpeg_plain
from sgs_tpu_torch.data.camera_utils import gt_from_image, load_cam, read_nerf_synthetic_split, target_size
from sgs_tpu_torch.data.gif import read_gif_info
from sgs_tpu_torch.data.png import read_png
from sgs_tpu_torch.data.readers import read_cameras_from_transforms
from sgs_tpu_torch.data.scene import Scene
from sgs_tpu_torch.get_psnr import main as get_psnr_main
from sgs_tpu_torch.metrics import evaluate, read_image
from sgs_tpu_torch.metrics import lpips as lpips_mod
from sgs_tpu_torch.metrics import main as metrics_main
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel, default_capacity
from sgs_tpu_torch.models.latent import LatentGaussianModel
from sgs_tpu_torch.models.vectorized import vectorized
from sgs_tpu_torch.ops import build, exp_forward, flat_raster, gather, jpeg as jpeg_ops, ssim as ssim_ops
from sgs_tpu_torch.ops.ssim import psnr
from sgs_tpu_torch.parallel import data_parallel, hybrid, mesh as mesh_lib, tile_shard
from sgs_tpu_torch.render.cli import main as render_main
from sgs_tpu_torch.render.cli import render_sets
from sgs_tpu_torch.render.pipeline import project_and_shade, render
from sgs_tpu_torch.render.tiled import bin_gaussians, kernel_args
from sgs_tpu_torch import bench
from sgs_tpu_torch import train_zero123
from sgs_tpu_torch import view as view_cli
from sgs_tpu_torch.analyze_model import main as analyze_main
from sgs_tpu_torch.tools import (bench_scale, colmap_scene, exp_bounds, exp_dma_gather, exp_fwd,
                                 exp_fwd2, exp_gather_layout, exp_scene, exp_transposed,
                                 exp_vmem_gather, gather_inputs, jpeg_times, l2_rate, oracle_times,
                                 scan_ablation)
# the bounds' peak rates (H100 SXM, NVIDIA's data sheet) are defined there
from sgs_tpu_torch.tools.exp_bounds import bound_ms
from sgs_tpu_torch.tools.ssim_times import time_ms
from sgs_tpu_torch.train.__main__ import main as train_main
from sgs_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from sgs_tpu_torch.train import lgm_trainer
from sgs_tpu_torch.train.loop import TrainState, eval_render, train_step
from sgs_tpu_torch.train.optim import AdamState, TreeAdamState, adam_tree_update, adam_update, make_lr_dict
from sgs_tpu_torch.train.trainer import training_report
from sgs_tpu_torch.train_lgm import main as train_lgm_main
from sgs_tpu_torch.utils.config import ModelParams, OptimizationParams, PipelineParams, save_cfg_args
from sgs_tpu_torch.utils.raytrace_scene import make_raytraced_dataset
from sgs_tpu_torch.utils.toy_scene import make_blender_dataset
from sgs_tpu_torch.viewer import network_gui

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
# Phase 11, the scene readers: data/flagship800 as COLMAP (binary and
# text) and at -r 2, a COLMAP capture of the flagship at 2000x1500 (the
# 1.6K downscale) and a Zero123 scene of it at 256x256.
READERS_DIR = ROOT / "build" / "smoke" / "readers"
# COLMAP form against Blender form: the camera matrices after the qvec
# round trip (a float32 ulp or so), and each view's PSNR (the same pixels)
CAMERA_ATOL, PSNR_FORMS_BAR = 1e-6, 1e-4
# The JAX package's per-view numbers on the copy's test split, copied
# from runs/colmap_flagship800_jax/model_{full,half}/per_view.json: its
# render.py (`--iteration 15000 -s <copy> -m <model> --quiet --eval
# --skip_train`, and again with `-r 2`) and metrics.py on the CPU, the
# trained flagship as iteration 15000 of <model> and <copy> written by
# `tools/colmap_scene.blender_to_colmap(data/flagship800, <copy>)`; the
# commands and their output are in runs/colmap_flagship800_jax/run.log,
# and tests/test_torch_colmap.py holds these tables to those files. The
# port is held to them per view within PSNR_BAR and SSIM_BAR. At -r 2 the
# model, trained at 800x800, loses 5-8 dB on the views it fits best (its
# splats are dilated by a fixed 0.3 px at any resolution): JAX loses the
# same.
JAX_COLMAP_PSNR = {
    -1: [13.526159286499023, 40.195228576660156, 39.55110549926758, 38.858497619628906,
         39.61309814453125, 39.25387954711914, 39.292137145996094],
    2: [13.531865119934082, 32.430850982666016, 33.409244537353516, 31.624155044555664,
        34.46583557128906, 32.79426956176758, 32.623836517333984],
}
JAX_COLMAP_SSIM = {
    -1: [0.8584892153739929, 0.993649423122406, 0.9924742579460144, 0.9905703663825989,
         0.9916015863418579, 0.9917429685592651, 0.991477370262146],
    2: [0.8300749063491821, 0.9732509851455688, 0.9777948260307312, 0.965461790561676,
        0.980380654335022, 0.9753411412239075, 0.9717289209365845],
}
CAPTURE_W, CAPTURE_H, CAPTURE_VIEWS = 2000, 1500, 24
CAPTURE_TRAIN_SIZE = (1600, 1200)  # what the 1.6K downscale must give
ZERO123_SIZE, ZERO123_VIEWS, ZERO123_ITERS = 256, 12, 30
# Phase 12, the evaluation chain. The JAX package's get_psnr.py on the
# committed LGM snapshot, both routes (`vec`: the (16000, 14) array JAX's
# vectorized wrote; `npz`: JAX's save_checkpoint of the snapshot at
# iteration 3000), rendered with the oracle as get_psnr.py renders; copied
# from runs/get_psnr_lgm400_jax/ (run.py writes the inputs and runs both,
# run.log holds the commands and output, <route>/losses.tsv each test
# row), and held equal to those files by tests/test_torch_get_psnr.py.
# (L1, PSNR) of the 8 test views and of all 48 train views.
JAX_GET_PSNR = {
    "vec": {"iteration": 0, "test": (0.049321080558001995, 21.30032992362976),
            "train": (0.04729995558348795, 21.54839567343394), "count": 16000},
    "npz": {"iteration": 3000, "test": (0.04932108288630843, 21.30032992362976),
            "train": (0.04729995597153902, 21.54839567343394), "count": 16000},
}
GET_PSNR_L1_BAR, GET_PSNR_DB_BAR = 1e-6, 1e-3
# the oracle's image against Kernel A's: the repository's image bar at
# every pixel but those that `tools/oracle_times.py::explain_pixels`
# accounts for by JAX's two f32 arrangements of the quadratic form (each
# image within the bar of its arrangement replayed one Gaussian at a time
# over the oracle's depth order, nothing dropped by binning), which must
# stay under NEAR_CUT_SHARE of the pixels; and Kernel A's report against
# the oracle's
ORACLE_ATOL, REPORT_DB_BAR = oracle_times.IMAGE_ATOL, 1e-4
ORACLE_FLAGSHIP_VIEWS = (0, 1)
EVAL_DIR = ROOT / "build" / "smoke" / "eval"
# seeded synthetic LPIPS weights (metrics/lpips.py::synthetic_weights); the
# card's value against the CPU's on one view
LPIPS_SEED, LPIPS_RTOL = 0, 1e-4


# Phase 13: the JPEG decoder and the tools.
TOOLS_DIR = ROOT / "build" / "smoke" / "tools"
JPEG_CASES = ROOT / "data" / "jpeg_cases"
JPEG_SCENE = ROOT / "data" / "colmap_flagship800_jpg"
JPEG_BIG = "flagship_4946x3286_q95_420.jpg"
JPEG_BIG_PROGRESSIVE = "flagship_4946x3286_q95_420_progressive.jpg"
PLAIN_JPEG_MAX_PX = 64_000  # the plain Python Huffman loop is held to the native one below this
# The JAX package's render.py and metrics.py on the JPEG copy's test split
# (PIL decodes the JPEGs), copied from
# runs/colmap_flagship800_jpg_jax/model_full/per_view.json (run.py there
# makes it; run.log has the commands); tests/test_torch_jpeg_scene.py
# holds these to that file. The port is held to them within PSNR_BAR and
# SSIM_BAR, the reader bars.
JAX_JPG_PSNR = [
    13.538168907165527, 35.80485534667969, 36.862022399902344, 35.243385314941406,
    37.15705490112305, 36.63990783691406, 35.6488151550293,
]
JAX_JPG_SSIM = [
    0.8489869832992554, 0.9688382148742676, 0.9735382795333862, 0.9602890610694885,
    0.9722972512245178, 0.9718735814094543, 0.9624995589256287,
]
VIEWER_ITERS, VIEWER_CONNECT_AT = 300, 150
VIEW_FRAMES, VIEW_SIZE, VIEW_ATOL = 24, 512, 3e-5
# the ray tracer's images against the committed data/lgm400: a byte may
# differ by 1 (numpy's transcendental functions may differ by an ulp
# between hosts) on under RAYTRACE_FLIP_SHARE of the pixels; the init
# cloud within RAYTRACE_XYZ_ATOL
RAYTRACE_FLIP_SHARE, RAYTRACE_XYZ_ATOL = 1e-3, 1e-6
# data/lgm400's arguments (assets/flagship/README.md gives flagship800's)
LGM_RAYTRACE = dict(n_train=48, n_test=8, width=400, height=400, n_init_points=20_000)
BLENDER_SIZE, BLENDER_ITERS = 128, 200
# The JAX package's analyze_model.py on assets/flagship/point_cloud.ply
# (`python analyze_model.py --ply assets/flagship/point_cloud.ply --out
# <dir>` on the CPU, its printed lines); tests/test_torch_analyze_cli.py
# holds the port's lines to the JAX CLI's on a small model.
JAX_ANALYZE_LINES = [
    "vectorize round trip OK ((161809, 11), (161809, 48))",
    "unnormalized: top-3 PCA explains 0.972",
    "normalized: top-3 PCA explains 0.243",
    "Done.",
]
# Phase 14 (parallel): 8 row bands of the 800x800 flagship view, held
# to the full render at JAX's band bars (tests/test_tile_shard.py:83-95:
# image atol 3e-5; gradients rtol 2e-3, atol 3e-6); the one-rank NCCL
# steps to `train_step` at tests/test_torch_train_step.py's bars (rtol
# 1e-4 plus 2e-4 of each field's largest magnitude; the loss rtol 1e-5);
# the torchrun CLI's losses.tsv to `--parallel none`'s at rtol 1e-4.
PARALLEL_DIR = ROOT / "build" / "smoke" / "parallel"
PARALLEL_BANDS = 8
BAND_ATOL, BAND_GRAD_RTOL, BAND_GRAD_ATOL = 3e-5, 2e-3, 3e-6
STEP_RTOL, STEP_ATOL_SCALE = 1e-4, 2e-4
PARALLEL_ITERS = 40
RECT_DIR = ROOT / "build" / "smoke" / "rect"
RECT_IMAGE_ATOL = 3e-5
# Phase 16 (bench): the flagship with bench.py's framing and the 5M garden
# scale (tools/bench_scale.py) at 1920x1080. JAX's binning counts there,
# from the JAX scripts' own count pre-passes (tests/bench_counts.py on the
# CPU: bench.py::_measure and scripts/bench_scale.py::run_config); the
# card's counts must equal them within BENCH_COUNT_RTOL of the count.
BENCH_SIZE = (1920, 1080)
BENCH_N = 5_000_000
JAX_BENCH_COUNTS = {
    "flagship": {"visible": 161_680, "rows": 439_749, "instances": 880_062},
    "capture": {"visible": 2_795_688, "rows": 4_753_918, "instances": 6_526_931},
    "all_visible": {"visible": 4_906_751, "rows": 8_350_160, "instances": 11_629_659},
}
BENCH_COUNT_RTOL = 1e-5
# the 5M view's A and C against their plain versions on the 8 longest
# tile lists and 8 more drawn with this seed (the other lists emptied)
BENCH_SAMPLE_TILES, BENCH_SAMPLE_SEED = 8, 16
STAMP = re.compile(r" \[\d\d/\d\d \d\d:\d\d:\d\d\]$")
MEASURED = {}


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
    build.build_all([*KERNELS, PROBE, old_alpha, jpeg_ops.DECODER])
    total = time.perf_counter() - t0
    for k in (*KERNELS, PROBE, old_alpha, jpeg_ops.DECODER):
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        say(f"[2 build] {k.source.name}: {k.build_seconds if k.build_seconds is not None else 0.0:.2f} s "
            f"(cached: {k.build_seconds is None}) {' | '.join(regs)}")
    say(f"[2 build] {len(KERNELS)} sources, the probe, PR 10's alpha path and the JPEG decoder ready in "
        f"{total:.2f} s")
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


def raster_inputs(sc: dict, width: int, height: int, tight: bool = True):
    """Bin a scene as the render path does (tightly, or each Gaussian's
    whole rect); returns (bins, Kernel A's args)."""
    bins = bin_gaussians(sc["mean2d"], sc["conic"], sc["opacity"], sc["depth"], sc["radius"],
                         sc["valid"], width, height, tight)
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
    """Run a CLI entry point in this process; returns what it printed, the
    time stamps of `safe_state` taken off the lines. sys.stdout is the
    same object after the call."""
    before = sys.stdout
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        fn([str(a) for a in argv])
    if sys.stdout is not before:
        raise AssertionError(f"{fn.__module__} left sys.stdout replaced")
    return "\n".join(STAMP.sub("", ln) for ln in tee.buf.getvalue().split("\n"))


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


def step_kernel_inputs(inputs, cam, gt, bg, tight: bool = True):
    """Kernels A-D's arguments in a training step on one view: (projection
    and shading, A's args, C's args, the image, the loss's cotangent for D)."""
    p = project_and_shade(cam, inputs)
    bins, args = raster_inputs(p, cam.image_width, cam.image_height, tight)
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
    got = step_grads(model, cam, gt, bg)
    with plain_path():
        want = step_grads(model, cam, gt, bg)
    torch.cuda.synchronize()
    worst = check_grads(got, want)

    # the step's own inputs to Kernels C and D
    _, args, bargs, img, cot = step_kernel_inputs(model.render_inputs(SH_DEGREE), cam, gt, bg)
    err_c = compare_raster_backward(bargs)
    err_d = compare_ssim_backward(img, gt, cot)
    err_b = compare_ssim(img, gt)
    say(f"[5 step] view 0: gradients through the kernels vs the plain path, max |err| / field max: "
        + ", ".join(f"{f} {v:.2e}" for f, v in worst.items())
        + f" (rtol {GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x max); B, C and D on the step's inputs "
          f"equal to their plain versions bit for bit")

    # stages of one step, CUDA events, means over the reps
    stages = host_stages(model, cam, 5)
    stages["A"] = time_ms(lambda: flat_raster.rasterize_tiles(*args), 10)
    stages["B"] = time_ms(lambda: ssim_ops.ssim_forward(img, gt), 20)
    inst = torch.empty((bargs[2].shape[0], flat_raster.N_GRADS), device=dev)
    stages["C walk"] = time_ms(lambda: flat_raster.raster_backward_walk(bargs, inst), 10)
    stages["C reduction"] = time_ms(lambda: flat_raster.reduce_runs(inst, bargs[12], bargs[13]), 10)
    c_ms = time_ms(lambda: flat_raster.rasterize_tiles_backward(*bargs), 10)
    stages["D"] = time_ms(lambda: ssim_ops.ssim_backward(img, gt, cot, with_dy=False), 20)
    d_both_ms = time_ms(lambda: ssim_ops.ssim_backward(img, gt, cot), 20)
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


def host_stages(model, cam, reps: int) -> dict:
    """The stages of a forward+backward around the kernels, host included
    (CUDA events, means over `reps`): projection and SH forward with the
    graph built, binning (`bin_gaussians` and the kernels' arguments), and
    autograd through projection and SH (phases 5 and 16)."""
    w, h = cam.image_width, cam.image_height
    leaves = {f: getattr(model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
    grad_model = model.with_params(leaves)
    stages = {"projection+SH": time_cuda(
        lambda: project_and_shade(cam, grad_model.render_inputs(SH_DEGREE)), reps)}
    pg = project_and_shade(cam, grad_model.render_inputs(SH_DEGREE))
    p = {k: v.detach() for k, v in pg.items()}
    stages["binning"] = time_cuda(lambda: raster_inputs(p, w, h), reps)
    outs = [pg["mean2d"], pg["conic"], pg["rgb"], pg["opacity"]]
    cots = [torch.ones_like(o) for o in outs]
    stages["autograd projection+SH"] = time_cuda(
        lambda: torch.autograd.grad(outs, list(leaves.values()), cots, retain_graph=True), reps)
    return stages


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


def c_bounds(bargs) -> tuple:
    """Kernel C's bounds on its arguments `bargs`, each (ms, what bounds
    it): the walk (point_list, perm, tile ranges and schedule, the records
    of the Gaussians in the lists (`exp_bounds.records_read`), t_final,
    n_contrib and dC per pixel, bg in; the instance gradients
    out; OPS_PER_PAIR_BWD operations per instance-pixel pair below
    n_contrib), the reduction (the instance gradients, rank starts and
    order in; the Gaussian gradients out) and C as a whole (the walk's
    inputs plus the reduction's rank starts and order in, the Gaussian
    gradients out)."""
    n, m = bargs[4].shape[0], bargs[2].shape[0]
    hw = bargs[5] * bargs[6]
    grad_bytes = 4 * flat_raster.N_GRADS
    records = 4 * flat_raster.REC_WIDTH * exp_bounds.records_read(bargs[2])
    walk_in = 12 * m + 12 * bargs[0].shape[0] + records + 20 * hw + 12
    walk_ops = flat_raster.OPS_PER_PAIR_BWD * float(bargs[8].sum())
    return (bound_ms(walk_in + grad_bytes * m, walk_ops),
            bound_ms(grad_bytes * m + 8 * (n + 1) + 8 * n + grad_bytes * n, flat_raster.N_GRADS * m),
            bound_ms(walk_in + 8 * (n + 1) + 8 * n + grad_bytes * n, walk_ops))


def phase_timing(dev, errs: dict, launches: dict, views, step: dict) -> list:
    model = GaussianModel.from_ply(str(FLAGSHIP_PLY), SH_DEGREE, dev)
    bg = torch.zeros(3, device=dev)
    tot = {"inst": 0, "render": 0.0, "ssim": 0.0, "A": 0.0, "B": 0.0}
    first = None
    for i, v in enumerate(views):
        out = render(v.camera, model.render_inputs(SH_DEGREE), bg)
        gt = read_image(SMOKE_DIR / "test" / METHOD / "gt" / f"{i:05d}.png", dev)
        q = read_image(SMOKE_DIR / "test" / METHOD / "renders" / f"{i:05d}.png", dev)
        render_ms = time_cuda(lambda: eval_render(model, v.camera, bg, SH_DEGREE, "tiled"), 3)
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
    a_row = exp_bounds.kernel_a(args, n_contrib)
    a_bound, a_by = a_row["bound_ms"], a_row["bound_by"]

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
    walk_bound, reduce_bound, (c_bound, c_by) = c_bounds(bargs)
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
             "E nocp": ("exp_forward E (nocp)", "scripts/exp_fwd.py:210",
                        exp_bounds.scan_counts(sc, "nocp"), "nocp"),
             "F": ("exp_forward F (alpha, krows 8, out_cols 8)", "scripts/exp_fwd2.py:84", every, "alpha"),
             "G": ("exp_forward G (hs, krows 8)", "scripts/exp_transposed.py:147", walked, "hs"),
             "G mxu": ("exp_forward G (mxu)", "scripts/exp_transposed.py:147", walked, "mxu")}
    bounds = {k: exp_bounds.forward(v[1], v[0], v[2], v[3]) for k, v in where.items()}
    # Kernel A on the same bins, for the comparison: its bound as in phase 7
    ka = sc["kernel_a"]
    _, _, n_contrib = flat_raster.rasterize_tiles(*ka)
    a_row = exp_bounds.kernel_a(ka, n_contrib)
    a_bound = (a_row["bound_ms"], a_row["bound_by"])
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


def phase_lgm_render(dev, out_dir: Path = LGM_RENDER_DIR, rasterizer: str = "tiled",
                     tag: str = "[10 lgm] snapshot") -> dict:
    """(a) The committed LGM snapshot through the render (with
    `--rasterizer rasterizer`) and metrics CLIs, held per view to the JAX
    package's numbers; returns the launch counts."""
    per_view = json.loads(LGM_PER_VIEW.read_text())[LGM_METHOD]
    # runs/lgm_r5/cfg_args, with this checkout's paths
    save_cfg_args(str(out_dir), ModelParams(
        sh_degree=0, source_path=str(LGM_SCENE), model_path=str(out_dir),
        white_background=False, eval=True))
    reset_counts()
    t0 = time.perf_counter()
    run_cli(render_main, ["-m", out_dir, "--ply", LGM_PLY, "--sh_degree", 0, "--iteration", 3000,
                          "--skip_train", "--rasterizer", rasterizer, "--device", dev.type])
    run_cli(metrics_main, ["-m", out_dir, "--device", dev.type])
    torch.cuda.synchronize()
    launches = read_counts()
    wall = time.perf_counter() - t0
    mine = json.loads((out_dir / "per_view.json").read_text())[LGM_METHOD]
    names = sorted(per_view["PSNR"])
    if sorted(mine["PSNR"]) != names:
        raise AssertionError(f"rendered views {sorted(mine['PSNR'])} != {names}")
    failures = []
    for name in names:
        dp = mine["PSNR"][name] - per_view["PSNR"][name]
        ds = mine["SSIM"][name] - per_view["SSIM"][name]
        say(f"{tag} {name}: PSNR {mine['PSNR'][name]:.4f} (JAX {per_view['PSNR'][name]:.4f}, "
            f"d {dp:+.5f}) SSIM {mine['SSIM'][name]:.6f} (JAX {per_view['SSIM'][name]:.6f}, d {ds:+.2e})")
        if abs(dp) > PSNR_BAR or abs(ds) > SSIM_BAR:
            failures.append(name)
    got = json.loads((out_dir / "results.json").read_text())[LGM_METHOD]
    results = json.loads(LGM_RESULTS.read_text())[LGM_METHOD]
    say(f"{tag} mean: PSNR {got['PSNR']:.7f} (JAX {results['PSNR']:.7f}, "
        f"d {got['PSNR'] - results['PSNR']:+.2e}) SSIM {got['SSIM']:.7f} (JAX {results['SSIM']:.7f}, "
        f"d {got['SSIM'] - results['SSIM']:+.2e}); launches A {launches['A']} B {launches['B']}; "
        f"render+metrics CLIs {wall:.2f} s")
    if failures:
        raise AssertionError(f"LGM views off the JAX numbers: {failures}")
    # the oracle launches no kernel; the metrics launch B once a view
    expected = only(A=len(names) if rasterizer == "tiled" else 0, B=len(names))
    if launches != expected:
        raise AssertionError(f"LGM render launches {launches}, expected {expected}")
    return launches


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
    return view_kernel_ms("[10 lgm]", label, inputs, cam, gt, bg)


def view_kernel_ms(tag, label, inputs, cam, gt, bg) -> dict:
    """Kernels A-D's device ms on one view's training-step inputs."""
    _, args, bargs, img, cot = step_kernel_inputs(inputs, cam, gt, bg)
    ms = {"A": time_ms(lambda: flat_raster.rasterize_tiles(*args), 10),
          "B": time_ms(lambda: ssim_ops.ssim_forward(img, gt), 20),
          "C": time_ms(lambda: flat_raster.rasterize_tiles_backward(*bargs), 10),
          "D": time_ms(lambda: ssim_ops.ssim_backward(img, gt, cot, with_dy=False), 20)}
    runs = bargs[12]
    say(f"{tag} {label}: {bargs[2].shape[0]} instances, longest tile list "
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
    if rate:
        MEASURED["lgm_it_s"] = float(rate[0].split("(")[1].split()[0])
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


def flagship_cameras(dev) -> tuple:
    """Every data/flagship800 view in the Blender form, by the name that
    its COLMAP copy gives it (`<split>_<stem>`), and its decoded image
    composited on black (what the COLMAP copy holds), by the same names:
    the PNGs are decoded once for phase 11."""
    out, images = {}, {}
    for split in ("train", "test"):
        infos = read_cameras_from_transforms(str(FLAGSHIP_SCENE), f"transforms_{split}.json",
                                             WHITE_BACKGROUND)
        for i, info in enumerate(infos):
            out[f"{split}_{info.image_name}"] = load_cam(-1, i, info, 1.0, dev)
            images[f"{split}_{info.image_name}"] = info.image
    return out, images


def view_psnr(model, view, bg) -> float:
    return float(psnr(eval_render(model, view.camera, bg, SH_DEGREE, "tiled"), view.gt_image))


def render_and_score(src: Path, model_dir: Path, dev, extra=()) -> tuple:
    """`python -m sgs_tpu_torch.render` with full_eval.py's argv, then
    `python -m sgs_tpu_torch.metrics`, on the trained flagship copied in as
    iteration 15000; returns (per-view PSNR, launches, wall s)."""
    snap = model_dir / "point_cloud" / "iteration_15000" / "point_cloud.ply"
    snap.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(FLAGSHIP_PLY, snap)
    reset_counts()
    t0 = time.perf_counter()
    run_cli(render_main, ["--iteration", 15000, "-s", src, "-m", model_dir, "--quiet", "--eval",
                          "--skip_train", *extra, "--device", dev.type])
    run_cli(metrics_main, ["-m", model_dir, "--device", dev.type])
    torch.cuda.synchronize()
    launches = read_counts()
    per_view = json.loads((model_dir / "per_view.json").read_text())[METHOD]
    return per_view, launches, time.perf_counter() - t0


def against_jax(label: str, per_view: dict, resolution: int) -> list:
    """Print each view's PSNR and SSIM beside the JAX package's on the
    same split (JAX_COLMAP_*); returns the views off the bars."""
    failures = []
    for i, name in enumerate(sorted(per_view["PSNR"])):
        p, q = per_view["PSNR"][name], per_view["SSIM"][name]
        dp = p - JAX_COLMAP_PSNR[resolution][i]
        ds = q - JAX_COLMAP_SSIM[resolution][i]
        say(f"[11 readers] {label} {name}: PSNR {p:.4f} (JAX {JAX_COLMAP_PSNR[resolution][i]:.4f}, "
            f"d {dp:+.5f}) SSIM {q:.6f} (JAX {JAX_COLMAP_SSIM[resolution][i]:.6f}, d {ds:+.2e})")
        if abs(dp) > PSNR_BAR or abs(ds) > SSIM_BAR:
            failures.append(name)
    return failures


def phase_readers_colmap(dev) -> dict:
    """(a) data/flagship800 as COLMAP, binary and text, against its Blender
    form, then the render and metrics CLIs on the copy's test split; (b)
    the same CLIs at -r 2. Returns the summed launch counts."""
    blender, composited = flagship_cameras(dev)
    model = GaussianModel.from_ply(str(FLAGSHIP_PLY), SH_DEGREE, dev)
    bg = torch.zeros(3, device=dev)
    want = {name: view_psnr(model, view, bg) for name, view in blender.items()}
    n_views = len(blender)
    n_test = len(range(0, n_views, 8))  # llffhold 8
    for form in ("bin", "txt"):
        src = READERS_DIR / f"flagship800_{form}"
        t0 = time.perf_counter()
        written = colmap_scene.blender_to_colmap(str(FLAGSHIP_SCENE), str(src), binary=form == "bin",
                                                 composited=composited)
        t1 = time.perf_counter()
        scene = Scene(ModelParams(sh_degree=SH_DEGREE, source_path=str(src), model_path="", eval=True),
                      shuffle=False, device=dev, ply_path=str(FLAGSHIP_PLY))
        load_s = time.perf_counter() - t0
        MEASURED[f"png_{form}_scene_load_s"] = time.perf_counter() - t1
        views = scene.getTrainCameras() + scene.getTestCameras()
        counts = (written, len(scene.getTrainCameras()), len(scene.getTestCameras()))
        if counts != (n_views, n_views - n_test, n_test):
            raise AssertionError(f"COLMAP {form}: {counts} (written, train, test), expected "
                                 f"{(n_views, n_views - n_test, n_test)}")
        cam_err, worst_dp = 0.0, 0.0
        for view in views:
            ref = blender[view.image_name]
            for key in ("world_view_transform", "full_proj_transform"):
                cam_err = max(cam_err, float((getattr(view.camera, key) - getattr(ref.camera, key)).abs().max()))
            if not torch.equal(view.gt_image, ref.gt_image):
                raise AssertionError(f"COLMAP {form} {view.image_name}: GT differs from the Blender form")
            worst_dp = max(worst_dp, abs(view_psnr(scene.pool, view, bg) - want[view.image_name]))
        say(f"[11 readers] (a) flagship800 as COLMAP ({form}): {written} images, "
            f"{counts[1]} train and {counts[2]} test; camera matrices within {cam_err:.2e} of the "
            f"Blender form (bar {CAMERA_ATOL}), GT pixels identical, the {len(views)} views' PSNR within "
            f"{worst_dp:.2e} dB of the Blender form's (bar {PSNR_FORMS_BAR}); written and loaded in "
            f"{load_s:.2f} s")
        if cam_err > CAMERA_ATOL or worst_dp > PSNR_FORMS_BAR:
            raise AssertionError(f"COLMAP {form}: cameras {cam_err}, PSNR {worst_dp} off the Blender form")

    src = READERS_DIR / "flagship800_bin"
    full, launches, wall = render_and_score(src, READERS_DIR / "model_full", dev)
    failures = against_jax("(a) full size", full, -1)
    say(f"[11 readers] (a) render+metrics CLIs (full_eval.py's argv) on the COLMAP test split: "
        f"mean PSNR {np.mean(list(full['PSNR'].values())):.4f} over {len(full['PSNR'])} views; launches "
        f"A {launches['A']} B {launches['B']}; {wall:.2f} s")
    if len(full["PSNR"]) != n_test or launches != only(A=n_test, B=n_test) or failures:
        raise AssertionError(f"render+metrics on COLMAP: {len(full['PSNR'])} views, launches "
                             f"{launches}, views off JAX's numbers {failures}")
    total = dict(launches)

    half_dir = READERS_DIR / "model_half"
    half, launches, wall = render_and_score(src, half_dir, dev, extra=("-r", 2))
    gt_shape = read_png(str(half_dir / "test" / METHOD / "gt" / "00000.png")).shape[:2]
    h, w = next(iter(blender.values())).gt_image.shape[1:]
    failures = against_jax(f"(b) -r 2, {w // 2}x{h // 2},", half, 2)
    drop = {n: half["PSNR"][n] - full["PSNR"][n] for n in sorted(half["PSNR"])}
    say(f"[11 readers] (b) -r 2: {len(drop)} views at {w // 2}x{h // 2}, PSNR against full size "
        + ", ".join(f"{d:+.4f}" for d in drop.values())
        + f" dB; launches A {launches['A']} B {launches['B']}; {wall:.2f} s")
    if gt_shape != (h // 2, w // 2) or sorted(drop) != sorted(full["PSNR"]) or failures \
            or launches != only(A=n_test, B=n_test):
        raise AssertionError(f"-r 2: GT {gt_shape}, views {sorted(drop)}, launches {launches}, "
                             f"views off JAX's numbers {failures}")
    return {k: total[k] + launches[k] for k in total}


def phase_readers_capture(dev, model) -> dict:
    """(c) A COLMAP capture of the flagship at 2000x1500 through the
    training CLI from scratch: the 1.6K downscale."""
    src = READERS_DIR / "capture2000"
    fovx, poses = colmap_scene.blender_poses(str(FLAGSHIP_SCENE), "train")
    poses = poses[:CAPTURE_VIEWS]
    xyz, rgb = colmap_scene.point_cloud_u8(str(FLAGSHIP_SCENE / "points3d.ply"))
    t0 = time.perf_counter()
    colmap_scene.capture_scene(model, poses, str(src), CAPTURE_W, CAPTURE_H, fovx, SH_DEGREE, xyz, rgb)
    capture_s = time.perf_counter() - t0
    out_dir = READERS_DIR / "train_capture"
    argv = ["-s", src, "-m", out_dir, "--eval", "--iterations", SCRATCH_ITERS,
            "--densify_from_iter", 20, "--densification_interval", 25, "--densify_until_iter", 90,
            "--test_iterations", 10, SCRATCH_ITERS, "--save_iterations", SCRATCH_ITERS,
            "--checkpoint_iterations", SCRATCH_ITERS, "--device", dev.type]
    reset_counts()
    t0 = time.perf_counter()
    out = run_cli(train_main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    rows = [r.split("\t") for r in (out_dir / "losses.tsv").read_text().strip().splitlines()[1:]]
    (it0, l1_0, psnr_0, n_0), (it1, l1_1, psnr_1, n_1) = rows
    n_test = len(range(0, len(poses), 8))  # llffhold 8
    reports = len(rows) * (n_test + 25)  # the test views and train views 5..29
    expected = only(A=SCRATCH_ITERS + reports, B=SCRATCH_ITERS, C=SCRATCH_ITERS, D=SCRATCH_ITERS)
    rate = [ln for ln in out.splitlines() if ln.startswith("Trained ")]
    say(f"[11 readers] (c) capture: {len(poses)} views at {CAPTURE_W}x{CAPTURE_H} rendered and "
        f"written in {capture_s:.2f} s; train CLI from {len(xyz)} points: test L1 {float(l1_0):.5f} -> "
        f"{float(l1_1):.5f}, PSNR {float(psnr_0):.3f} -> {float(psnr_1):.3f}, Gaussians {n_0} -> {n_1}; "
        f"{rate[0] if rate else 'no rate line'}; call {wall:.2f} s; launches {launches}")
    if not float(l1_1) < float(l1_0) or n_1 == n_0:
        raise AssertionError(f"capture training: L1 {l1_0} -> {l1_1}, Gaussians {n_0} -> {n_1}")
    if launches != expected:
        raise AssertionError(f"capture training launches {launches}, expected {expected}")

    t0 = time.perf_counter()
    scene = Scene(ModelParams(sh_degree=SH_DEGREE, source_path=str(src), model_path="", eval=True),
                  shuffle=False, device=dev)
    load_s = time.perf_counter() - t0
    views = scene.getTrainCameras() + scene.getTestCameras()
    sizes = {tuple(v.gt_image.shape) for v in views} | {(3, v.camera.image_height, v.camera.image_width)
                                                        for v in views}
    want = (3, CAPTURE_TRAIN_SIZE[1], CAPTURE_TRAIN_SIZE[0])
    if sizes != {want}:
        raise AssertionError(f"capture cameras and GT at {sizes}, expected {want}")
    view = scene.getTrainCameras()[0]
    cam, gt = view.camera, view.gt_image
    bg = torch.zeros(3, device=dev)
    state = TrainState(model=scene.pool, adam=AdamState.init(scene.pool.params()),
                       stats=DensifyStats.zeros(scene.pool.capacity, dev))
    lrs = make_lr_dict(OptimizationParams(), scene.cameras_extent, 1)
    step_ms = time_cuda(lambda: train_step(state, cam, gt, bg, lrs, 0), 5)
    size = f"{CAPTURE_TRAIN_SIZE[0]}x{CAPTURE_TRAIN_SIZE[1]}"
    say(f"[11 readers] (c) scene load ({len(views)} views from {CAPTURE_W}x{CAPTURE_H} to {size}) "
        f"{load_s:.2f} s; one training step at init ({scene.pool.num_alive} Gaussians, {size}, "
        f"train view 0) {step_ms:.3f} ms")
    trained = load_checkpoint(str(out_dir / f"chkpnt{SCRATCH_ITERS}.npz"), dev)[0].model
    for label, m in (("at init", scene.pool), (f"at {SCRATCH_ITERS}", trained)):
        with torch.no_grad():
            inputs = m.render_inputs(0)
        view_kernel_ms("[11 readers]", f"(c) {size} train view 0 {label}", inputs, cam, gt, bg)
    return launches


def phase_readers_zero123(dev, model) -> dict:
    """(d) A Zero123 scene of the flagship through the training CLI with
    the argv of `python -m sgs_tpu_torch.train_zero123`: the structure
    stays frozen."""
    src = READERS_DIR / "zero123"
    _, poses = colmap_scene.blender_poses(str(FLAGSHIP_SCENE), "train")
    glb = colmap_scene.zero123_scene(model, poses[:ZERO123_VIEWS], str(src), ZERO123_SIZE, SH_DEGREE)
    rgba = read_png(str(src / "000.png"))
    out_dir = READERS_DIR / "train_zero123"
    argv = train_zero123.train_argv(str(src), glb, str(out_dir), iterations=ZERO123_ITERS)
    reset_counts()
    t0 = time.perf_counter()
    run_cli(train_main, [*argv, "--device", dev.type])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    init = load_point_cloud_ply(str(out_dir / "input.ply"))[0]
    snap = load_gaussian_ply(str(out_dir / "point_cloud" / f"iteration_{ZERO123_ITERS}" / "point_cloud.ply"),
                             SH_DEGREE)
    say(f"[11 readers] (d) Zero123: {ZERO123_VIEWS} RGBA views at {ZERO123_SIZE}x{ZERO123_SIZE} "
        f"(alpha {int(rgba[..., 3].min())}..{int(rgba[..., 3].max())}), a GLB of {len(init)} faces; "
        f"{ZERO123_ITERS} iterations with --freeze_xyz: xyz equal to the init bit for bit: "
        f"{np.array_equal(snap['xyz'], init)}; call {wall:.2f} s; launches {launches}")
    if rgba.shape[2] != 4 or not np.array_equal(snap["xyz"], init):
        raise AssertionError(f"Zero123: image {rgba.shape}, or the frozen xyz moved")
    # the CLI's default test, save and checkpoint lists are one list, which
    # takes --iterations (as in train.py): one report at the end
    steps, report = ZERO123_ITERS, (ZERO123_VIEWS - 10) + 25
    if launches != only(A=steps + report, B=steps, C=steps, D=steps):
        raise AssertionError(f"Zero123 training launches {launches}, expected A {steps} + {report}, "
                             f"B-D {steps}")
    return launches


def phase_readers(dev) -> dict:
    """Phase 11: the scene readers; returns A-D's launches summed over its
    four runs."""
    t0 = time.perf_counter()
    shutil.rmtree(READERS_DIR, ignore_errors=True)
    total = phase_readers_colmap(dev)
    model = GaussianModel.from_ply(str(FLAGSHIP_PLY), SH_DEGREE, dev)
    for run in (phase_readers_capture, phase_readers_zero123):
        launches = run(dev, model)
        total = {k: total[k] + launches[k] for k in total}
    say(f"[11 readers] phase wall {time.perf_counter() - t0:.2f} s; launches over (a)-(d) {total}")
    return total


REPORT_LINE = re.compile(r"\[ITER (\d+)\] Evaluating (\w+): L1 (\S+) PSNR (\S+)")
# operations of one pair test of the oracle (`render/reference.py`): the
# offsets, the conic's quadratic form, exp, opacity and clamp, the cuts,
# 1 - alpha, the cumulative product, the stop test, the weight and its
# three colour FMAs
ORACLE_OPS_PER_PAIR = 30


def report_lines(printed: str) -> dict:
    """{split: (L1, PSNR)} of the `[ITER n] Evaluating <split>` lines."""
    return {m.group(2): (float(m.group(3)), float(m.group(4))) for m in REPORT_LINE.finditer(printed)}


def one_call_ms(fn):
    """(result, ms) of one call of `fn`, synchronised before and after: a
    call of seconds, timed by the host clock."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def phase_eval_get_psnr(dev) -> dict:
    """(a) `python -m sgs_tpu_torch.get_psnr` on the committed LGM snapshot,
    through the `.npy` that the port's `vectorized` writes and the npz that
    its checkpoint writer writes, each against the JAX package's
    get_psnr.py on the same files (JAX_GET_PSNR). Returns each route's
    numbers."""
    model = GaussianModel.from_ply(str(LGM_PLY), 0, dev)
    inputs = {"vec": EVAL_DIR / "vec.npy", "npz": EVAL_DIR / "snapshot.npz"}
    np.save(inputs["vec"], np.concatenate(vectorized(model), axis=1))
    save_checkpoint(str(inputs["npz"]), TrainState(model=model, adam=AdamState.init(model.params()),
                                                   stats=DensifyStats.zeros(model.capacity, dev)),
                    3000, 0, 1.0)
    got = {}
    for route, path in inputs.items():
        out_dir = EVAL_DIR / f"get_psnr_{route}"
        reset_counts()
        t0 = time.perf_counter()
        printed = run_cli(get_psnr_main, ["-s", LGM_SCENE, "-m", out_dir, "--eval", "--sh_degree", 0,
                                          "--start_checkpoint", path, "--device", dev.type])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        row = (out_dir / "losses.tsv").read_text().splitlines()[1].split("\t")
        lines = report_lines(printed)
        mine = {"iteration": int(row[0]), "test": (float(row[1]), float(row[2])),
                "train": lines["train"], "count": int(row[3])}
        want = JAX_GET_PSNR[route]
        diffs = {s: (mine[s][0] - want[s][0], mine[s][1] - want[s][1]) for s in ("test", "train")}
        say(f"[12 eval] (a) get_psnr, {route} route: iteration {mine['iteration']}, {mine['count']} "
            f"Gaussians; " + "; ".join(f"{s} L1 {mine[s][0]:.9f} (JAX {want[s][0]:.9f}, d {d[0]:+.2e}) "
                                       f"PSNR {mine[s][1]:.6f} (JAX {want[s][1]:.6f}, d {d[1]:+.2e})"
                                       for s, d in diffs.items())
            + f"; launches {launches}; {wall:.2f} s")
        if (mine["iteration"], mine["count"]) != (want["iteration"], want["count"]) \
                or lines["test"] != mine["test"] or launches != only() \
                or any(abs(d[0]) > GET_PSNR_L1_BAR or abs(d[1]) > GET_PSNR_DB_BAR for d in diffs.values()):
            raise AssertionError(f"get_psnr {route}: {mine} against JAX's {want}, launches {launches}")
        got[route] = mine
    return got


def phase_eval_oracle(dev, flagship_views) -> dict:
    """(b) The oracle against Kernel A at full width: the flagship on test
    views ORACLE_FLAGSHIP_VIEWS and the LGM snapshot on its 8 test views.
    Returns each model's mean oracle ms per view and pair tests per view."""
    lgm_views = read_nerf_synthetic_split(str(LGM_SCENE), "test", False, -1, dev)
    bg = torch.zeros(3, device=dev)
    out = {}
    for label, ply, sh, views in (
            ("flagship", FLAGSHIP_PLY, SH_DEGREE, [(i, flagship_views[i]) for i in ORACLE_FLAGSHIP_VIEWS]),
            ("lgm", LGM_PLY, 0, list(enumerate(lgm_views)))):
        model = GaussianModel.from_ply(str(ply), sh, dev)
        inputs = model.render_inputs(sh)
        stats = {"ms": [], "pairs": [], "err": 0.0}
        for i, v in views:
            cam = v.camera
            w, h = cam.image_width, cam.image_height
            with torch.no_grad():
                tiled = render(cam, inputs, bg, mode="tiled")["render"]
                ref, ms = one_call_ms(lambda: render(cam, inputs, bg, mode="reference")["render"])
                p = project_and_shade(cam, inputs)
                bins, args = raster_inputs(p, w, h)
                over = oracle_times.explain_pixels(p, bins, ref, tiled, ORACLE_ATOL)
            err = float((ref - tiled).abs().max())
            unexplained = [m for m in over if not m["explained"]]
            pairs = int(p["valid"].sum()) * w * h
            tiled_ms = time_cuda(lambda: render(cam, inputs, bg, mode="tiled"), 3)
            a_ms = time_ms(lambda: flat_raster.rasterize_tiles(*args), 10)
            say(f"[12 eval] (b) {label} test view {i} ({w}x{h}): |oracle - Kernel A| {err:.2e}; "
                f"{len(over)} pixels over {ORACLE_ATOL}, {len(over) - len(unexplained)} of them each within "
                f"the bar of its arrangement replayed, nothing dropped by binning"
                + "".join(f"; {m['pixel']} d {max(abs(u - v) for u, v in zip(m['oracle_px'], m['tiled_px'])):.2e}"
                          f" flips {len(m['flips'])} |T - 1e-4| {m['t']:.1e}" for m in over[:6])
                + f"; oracle {ms:.1f} ms for {pairs:.4g} pair tests ({pairs / ms * 1e3:.4g} a second); "
                f"tiled render {tiled_ms:.3f} ms, Kernel A {a_ms:.4f} ms")
            if unexplained or len(over) > NEAR_CUT_SHARE * w * h:
                raise AssertionError(f"oracle {label} view {i}: {len(over)} pixels over {ORACLE_ATOL}, "
                                     f"not accounted for: {unexplained[:10]}")
            stats["ms"].append(ms)
            stats["pairs"].append(pairs)
            stats["err"] = max(stats["err"], err)
        bound, by = bound_ms(0.0, ORACLE_OPS_PER_PAIR * float(np.mean(stats["pairs"])))
        out[label] = {"ms": float(np.mean(stats["ms"])), "pairs": float(np.mean(stats["pairs"])),
                      "err": stats["err"], "bound_ms": bound}
        say(f"[12 eval] (b) {label}: oracle mean {out[label]['ms']:.1f} ms a view over {len(views)} views, "
            f"{out[label]['pairs']:.4g} pair tests a view, bound {bound:.3f} ms ({by}, "
            f"{ORACLE_OPS_PER_PAIR} operations a pair); worst |oracle - Kernel A| {stats['err']:.2e}")
    return out


def phase_eval_lpips(dev) -> dict:
    """(d) LPIPS through the metrics CLI with seeded synthetic weights on the
    flagship renders of phase 4; one view's value against the port's on
    the CPU; ms per 800x800 pair. Returns the launch counts."""
    weights = EVAL_DIR / "lpips" / "lpips_vgg16.npz"
    weights.parent.mkdir(parents=True, exist_ok=True)
    np.savez(weights, **lpips_mod.synthetic_weights(LPIPS_SEED))
    os.environ["SGS_LPIPS_WEIGHTS"] = str(weights)
    try:
        reset_counts()
        run_cli(metrics_main, ["-m", SMOKE_DIR, "--device", dev.type])
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        del os.environ["SGS_LPIPS_WEIGHTS"]
    per_view = json.loads((SMOKE_DIR / "per_view.json").read_text())[METHOD]["LPIPS"]
    mean = json.loads((SMOKE_DIR / "results.json").read_text())[METHOD]["LPIPS"]
    names = sorted(per_view)
    method_dir = SMOKE_DIR / "test" / METHOD
    cpu = torch.device("cpu")
    r, g = (read_image(method_dir / d / names[0], cpu) for d in ("renders", "gt"))
    cpu_value, cpu_ms = one_call_ms(lambda: float(lpips_mod.lpips(r, g, weights_path=str(weights))[0]))
    rd, gd = r.to(dev), g.to(dev)
    pair_ms = time_cuda(lambda: lpips_mod.lpips(rd, gd, weights_path=str(weights)), 5)
    rel = abs(per_view[names[0]] - cpu_value) / abs(cpu_value)
    say(f"[12 eval] (d) LPIPS (synthetic VGG16 weights, seed {LPIPS_SEED}) through the metrics CLI on "
        f"phase 4's {len(names)} flagship renders: mean {mean}, per view "
        + ", ".join(f"{per_view[n]:.6f}" for n in names)
        + f"; {names[0]} on the card {per_view[names[0]]:.8f}, on the CPU {cpu_value:.8f} (rel {rel:.2e}, "
        f"bar {LPIPS_RTOL}; CPU {cpu_ms:.0f} ms); {pair_ms:.3f} ms a {r.shape[2]}x{r.shape[1]} pair on "
        f"the card; launches {launches}")
    if mean is None or not all(np.isfinite(per_view[n]) and per_view[n] > 0 for n in names) \
            or rel > LPIPS_RTOL or launches != only(B=len(names)):
        raise AssertionError(f"LPIPS: mean {mean}, per view {per_view}, CPU {cpu_value}, launches {launches}")
    return launches


def phase_eval_full_eval(dev) -> None:
    """(e) `python -m sgs_tpu_torch.full_eval --skip_training
    --skip_rendering` as a subprocess over the model directories of phases
    4 and 10 (linked in as two of its scenes): the results.json it writes
    must equal theirs."""
    out = EVAL_DIR / "full_eval"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    want = {}
    for scene, model_dir in (("bicycle", SMOKE_DIR), ("flowers", LGM_RENDER_DIR)):
        (out / scene).symlink_to(model_dir, target_is_directory=True)
        want[scene] = json.loads((model_dir / "results.json").read_text())
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "sgs_tpu_torch.full_eval", "--skip_training",
                          "--skip_rendering", "--output_path", str(out)],
                         cwd=ROOT, capture_output=True, text=True)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"full_eval exited {res.returncode}: {res.stderr[-2000:]}")
    got = {scene: json.loads((out / scene / "results.json").read_text()) for scene in want}
    say(f"[12 eval] (e) full_eval metrics-only subprocess over 13 scene paths ({len(want)} present): "
        f"results.json equal to phases 4 and 10: {got == want}; {wall:.2f} s; its first command: "
        f"{res.stdout.splitlines()[0][:120] if res.stdout else ''}")
    if got != want:
        raise AssertionError(f"full_eval results {got} != {want}")


def phase_eval_report(dev, oracle: dict) -> dict:
    """(f) `training_report(full_train_set=True, mode="tiled")` on the LGM
    snapshot: A once a view, B never; its numbers against the oracle's of
    (a) (the npz route: the same parameters). Returns the launch counts."""
    scene = Scene(ModelParams(sh_degree=0, source_path=str(LGM_SCENE), model_path="", eval=True), device=dev)
    model = GaussianModel.from_ply(str(LGM_PLY), 0, dev)
    bg = torch.zeros(3, device=dev)
    n_views = len(scene.getTestCameras()) + len(scene.getTrainCameras())
    reset_counts()
    t0 = time.perf_counter()
    printed = run_cli(lambda _: training_report(None, 3000, scene, model, 0, bg, mode="tiled",
                                                full_train_set=True), [])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    got = report_lines(printed)
    want = {s: oracle["npz"][s] for s in ("test", "train")}
    diffs = {s: got[s][1] - want[s][1] for s in want}
    say(f"[12 eval] (f) training_report(full_train_set=True, mode=\"tiled\") on the LGM snapshot: "
        + "; ".join(f"{s} PSNR {got[s][1]:.6f} (oracle {want[s][1]:.6f}, d {d:+.2e})" for s, d in diffs.items())
        + f"; launches {launches}; {wall:.2f} s for {n_views} views")
    if any(abs(d) > REPORT_DB_BAR for d in diffs.values()) or launches != only(A=n_views):
        raise AssertionError(f"tiled report {got} against the oracle's {want}, launches {launches}")
    return launches


def phase_eval(dev, flagship_views) -> dict:
    """Phase 12: the evaluation chain; returns A's and B's launches summed
    over its runs in this process."""
    t0 = time.perf_counter()
    shutil.rmtree(EVAL_DIR, ignore_errors=True)
    EVAL_DIR.mkdir(parents=True)
    oracle = phase_eval_get_psnr(dev)
    timing = phase_eval_oracle(dev, flagship_views)
    total = phase_lgm_render(dev, EVAL_DIR / "lgm_reference", "reference", "[12 eval] (c) oracle")
    phase_eval_full_eval(dev)
    for launches in (phase_eval_lpips(dev), phase_eval_report(dev, oracle)):
        total = {k: total[k] + launches[k] for k in total}
    say(f"[12 eval] phase wall {time.perf_counter() - t0:.2f} s; launches over (a)-(f) {total}")
    return {"launches": total, "oracle": timing}


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo gives it: model name, vendor, family
    and model numbers (a virtualised host may name its model "unknown"), with
    the core count."""
    info = {}
    for ln in Path("/proc/cpuinfo").read_text().splitlines():
        key, _, value = ln.partition(":")
        info.setdefault(key.strip(), value.strip())
    fields = [info.get(k, "?") for k in ("model name", "vendor_id", "cpu family", "model")]
    return f"{fields[0]} ({fields[1]} family {fields[2]} model {fields[3]}), {os.cpu_count()} cores"


def phase_tools_jpeg() -> None:
    """(a) Every committed case through the native decoder against PIL's
    digest, and against the plain decoder under PLAIN_JPEG_MAX_PX (the
    progressive cases among them, those libjpeg smooths counted); the
    native ms per Mpx on the 800x800 views and the 4946x3286 frame,
    baseline and progressive, by `tools/jpeg_times.py`."""
    digests = json.loads((JPEG_CASES / "digests.json").read_text())
    plain_checked, progressive, smoothed = 0, 0, 0
    for name, want in sorted(digests.items()):
        path = str(JPEG_CASES / name)
        got = jpeg_ops.read_jpeg_native(path)
        if hashlib.sha256(got.tobytes()).hexdigest() != want["sha256"] or list(got.shape) != want["shape"]:
            raise AssertionError(f"native JPEG decode of {name} differs from PIL's digest")
        if got.shape[0] * got.shape[1] < PLAIN_JPEG_MAX_PX:
            if not np.array_equal(got, jpeg_plain.read_jpeg(path)):
                raise AssertionError(f"native JPEG decode of {name} differs from the plain decoder")
            plain_checked += 1
        frame = jpeg_plain.parse_jpeg(Path(path).read_bytes(), name)
        progressive += frame.progressive
        smoothed += jpeg_plain.smoothing_wanted(frame, jpeg_plain.coefficient_bits(frame))
    if not smoothed:
        raise AssertionError("no committed JPEG case exercises block smoothing")
    times = jpeg_times.main(ROOT)
    frames = times["frames_ms_per_mpx"]
    if sorted(frames) != sorted((JPEG_BIG, JPEG_BIG_PROGRESSIVE)) or not times["views"]:
        raise AssertionError(f"JPEG times: {times['views']} views, frames {sorted(frames)}")
    MEASURED["jpeg_ms_per_mpx"] = times["views_ms_per_mpx"]
    MEASURED["jpeg_big_ms_per_mpx"] = {"baseline": frames[JPEG_BIG], "progressive": frames[JPEG_BIG_PROGRESSIVE]}
    big = {k: v * jpeg_times.BIG_MPX for k, v in MEASURED["jpeg_big_ms_per_mpx"].items()}
    say(f"[13 tools] (a) JPEG: {len(digests)} committed cases ({progressive} progressive, {smoothed} of them "
        f"smoothed) decoded natively equal to PIL's digests, {plain_checked} (under {PLAIN_JPEG_MAX_PX} px) "
        f"also equal to the plain decoder; native decode {MEASURED['jpeg_ms_per_mpx']:.2f} ms/Mpx over the "
        f"{times['views']} 800x800 views ({MEASURED['jpeg_ms_per_mpx'] * jpeg_times.VIEW_MPX:.2f} ms a view), "
        f"4946x3286 frame baseline {big['baseline']:.1f} ms ({frames[JPEG_BIG]:.2f} ms/Mpx), progressive "
        f"{big['progressive']:.1f} ms ({frames[JPEG_BIG_PROGRESSIVE]:.2f} ms/Mpx), medians of 3 "
        f"(`tools/jpeg_times.py`); "
        f"host CPU {host_cpu()}")


def scene_load_s(src: Path, dev) -> tuple:
    t0 = time.perf_counter()
    scene = Scene(ModelParams(sh_degree=SH_DEGREE, source_path=str(src), model_path="", eval=True),
                  shuffle=False, device=dev, ply_path=str(FLAGSHIP_PLY))
    return scene, time.perf_counter() - t0


def phase_tools_jpeg_scene(dev) -> dict:
    """(b) The JPEG COLMAP flagship: load time beside the PNG copy's, the
    render and metrics CLIs held to JAX's numbers, 100 iterations from
    points3d, and the 4946x3286 frame through the -r -1 rule."""
    src = TOOLS_DIR / "flagship800_jpg"
    shutil.copytree(JPEG_SCENE, src)
    loads = []
    for _ in range(2):
        scene, s = scene_load_s(src, dev)
        loads.append(s)
    n_test = len(scene.getTestCameras())
    n_views = len(list((src / "images").glob("*.jpg")))
    png_s = MEASURED.get("png_bin_scene_load_s", float("nan"))
    say(f"[13 tools] (b) JPEG COLMAP flagship ({n_views} views): scene load "
        + ", ".join(f"{s:.2f}" for s in loads) + f" s, beside phase 11's binary PNG copy {png_s:.2f} s; "
        f"{len(scene.getTrainCameras())} train, {n_test} test")
    if (len(scene.getTrainCameras()), n_test) != (n_views - len(range(0, n_views, 8)), len(range(0, n_views, 8))):
        raise AssertionError(f"JPEG copy: {len(scene.getTrainCameras())} train, {n_test} test")
    per_view, launches, wall = render_and_score(src, TOOLS_DIR / "model_jpg", dev)
    failures = []
    for i, name in enumerate(sorted(per_view["PSNR"])):
        p, q = per_view["PSNR"][name], per_view["SSIM"][name]
        dp, ds = p - JAX_JPG_PSNR[i], q - JAX_JPG_SSIM[i]
        say(f"[13 tools] (b) JPEG copy {name}: PSNR {p:.4f} (JAX {JAX_JPG_PSNR[i]:.4f}, d {dp:+.5f}) "
            f"SSIM {q:.6f} (JAX {JAX_JPG_SSIM[i]:.6f}, d {ds:+.2e})")
        if abs(dp) > PSNR_BAR or abs(ds) > SSIM_BAR:
            failures.append(name)
    if len(per_view["PSNR"]) != n_test or launches != only(A=n_test, B=n_test) or failures:
        raise AssertionError(f"render+metrics on the JPEG copy: {len(per_view['PSNR'])} views, "
                             f"launches {launches}, views off JAX's numbers {failures}")
    say(f"[13 tools] (b) render+metrics CLIs: {wall:.2f} s, launches A {launches['A']} B {launches['B']}")
    total = dict(launches)

    out_dir = TOOLS_DIR / "train_jpg"
    argv = ["-s", src, "-m", out_dir, "--eval", "--iterations", SCRATCH_ITERS,
            "--densify_from_iter", 20, "--densification_interval", 25, "--densify_until_iter", 90,
            "--test_iterations", 10, SCRATCH_ITERS, "--save_iterations", SCRATCH_ITERS,
            "--checkpoint_iterations", SCRATCH_ITERS, "--device", dev.type]
    reset_counts()
    t0 = time.perf_counter()
    out = run_cli(train_main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    rows = [r.split("\t") for r in (out_dir / "losses.tsv").read_text().strip().splitlines()[1:]]
    (it0, l1_0, psnr_0, n_0), (it1, l1_1, psnr_1, n_1) = rows
    reports = len(rows) * (n_test + 25)  # the test views and train views 5..29
    expected = only(A=SCRATCH_ITERS + reports, B=SCRATCH_ITERS, C=SCRATCH_ITERS, D=SCRATCH_ITERS)
    rate = [ln for ln in out.splitlines() if ln.startswith("Trained ")]
    say(f"[13 tools] (b) train CLI on the JPEG copy from points3d: test L1 {float(l1_0):.5f} -> "
        f"{float(l1_1):.5f}, PSNR {float(psnr_0):.3f} -> {float(psnr_1):.3f}, Gaussians {n_0} -> {n_1}; "
        f"{rate[0] if rate else 'no rate line'}; call {wall:.2f} s; launches {launches}")
    if not float(l1_1) < float(l1_0) or launches != expected:
        raise AssertionError(f"JPEG training: L1 {l1_0} -> {l1_1}, launches {launches}, expected {expected}")
    total = {k: total[k] + launches[k] for k in total}

    big = TOOLS_DIR / "big"
    (big / "images").mkdir(parents=True)
    shutil.copyfile(JPEG_CASES / JPEG_BIG, big / "images" / JPEG_BIG)
    xyz, rgb = colmap_scene.point_cloud_u8(str(FLAGSHIP_SCENE / "points3d.ply"))
    _, poses = colmap_scene.blender_poses(str(FLAGSHIP_SCENE), "train")
    colmap_scene.write_sparse(str(big), colmap_scene.pinhole(4946, 3286, 0.9), [(JPEG_BIG, poses[0][1])],
                              xyz, rgb)
    t0 = time.perf_counter()
    scene = Scene(ModelParams(sh_degree=SH_DEGREE, source_path=str(big), model_path="", eval=False),
                  shuffle=False, device=dev, ply_path=str(FLAGSHIP_PLY))
    load_s = time.perf_counter() - t0
    gt = scene.getTrainCameras()[0].gt_image.cpu().numpy()
    decoded = jpeg_ops.read_jpeg_native(str(big / "images" / JPEG_BIG))
    want = gt_from_image(decoded, target_size(-1, 4946, 3286))
    say(f"[13 tools] (b) 4946x3286 JPEG through -r -1: GT {gt.shape[2]}x{gt.shape[1]}, equal to the "
        f"plain resize of the same decode: {np.array_equal(gt, want)}; scene load {load_s:.2f} s")
    if gt.shape != (3, 1063, 1600) or not np.array_equal(gt, want):
        raise AssertionError(f"the 1.6K GT of the 4946x3286 JPEG: {gt.shape}, or differs from the plain resize")
    return total


def _viewer_message(cam, train: int, keep_alive: int, scaling_modifier: float) -> bytes:
    """A SIBR viewer's request for `cam`: the transposed matrices with the
    y/z columns flipped, as the viewer sends them."""
    view = cam.world_view_transform.cpu().numpy().copy()
    proj = cam.full_proj_transform.cpu().numpy().copy()
    view[:, 1] *= -1
    view[:, 2] *= -1
    proj[:, 1] *= -1
    fovx = 2 * math.atan(float(cam.tanfovx))
    fovy = 2 * math.atan(float(cam.tanfovy))
    msg = {"resolution_x": cam.image_width, "resolution_y": cam.image_height, "train": train,
           "fov_x": fovx, "fov_y": fovy, "z_near": 0.01, "z_far": 100.0, "shs_python": 0,
           "rot_scale_python": 0, "keep_alive": keep_alive, "scaling_modifier": scaling_modifier,
           "view_matrix": view.ravel().tolist(), "view_projection_matrix": proj.ravel().tolist()}
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload


def _recv_exact(sock, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the server closed the connection")
        buf += chunk
    return buf


def phase_tools_viewer(dev) -> dict:
    """(c) `python -m sgs_tpu_torch.train_lgm` with the viewer listening: a
    client holds the loop (train=0), takes two frames, then releases it;
    every served frame equals `image_to_bytes` of the trainer's render of
    the same camera and scaling modifier, rendered while the loop is held."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    views = read_nerf_synthetic_split(str(LGM_SCENE), "test", WHITE_BACKGROUND, -1, dev)
    requests = [(views[0].camera, 0, 1, 1.0), (views[1].camera, 0, 1, 0.8), (views[2].camera, 1, 0, 1.0)]
    served, stamps, errors = [], [], []
    real_serve = network_gui.serve

    def spy(render_cb, source_path, iteration, max_iterations, device="cuda"):
        stamps.append((iteration, time.perf_counter()))
        spy.render_cb = render_cb
        real_serve(render_cb, source_path, iteration, max_iterations, device)

    def expected(cam, sm):
        a = flat_raster.KERNEL.launches
        with torch.no_grad():
            want = network_gui.image_to_bytes(spy.render_cb(cam, sm))
        flat_raster.KERNEL.launches = a
        return want

    def client():
        try:
            while len(stamps) < VIEWER_CONNECT_AT:
                time.sleep(0.005)
            with socket.create_connection(("127.0.0.1", port), timeout=60) as c:
                for cam, train, keep_alive, sm in requests:
                    # the trainer's render of the request, made while the
                    # loop is held (after the first frame): its parameters
                    # are the served frame's; the launch is not counted
                    if train:
                        want = expected(cam, sm)
                    c.sendall(_viewer_message(cam, train, keep_alive, sm))
                    image = _recv_exact(c, cam.image_width * cam.image_height * 3)
                    path = _recv_exact(c, int.from_bytes(_recv_exact(c, 4), "little")).decode()
                    if not train:
                        want = expected(cam, sm)
                    served.append((image == want, path, stamps[-1][0]))
        except Exception as e:  # reported by the main thread
            errors.append(repr(e))

    out_dir = TOOLS_DIR / "train_lgm_viewer"
    argv = ["-s", LGM_SCENE, "-m", out_dir, "--eval", "--iterations", VIEWER_ITERS,
            "--downsample_init", LGM_DOWNSAMPLE, "--sh_degree", 0, "--port", port,
            "--test_iterations", VIEWER_ITERS, "--save_iterations", VIEWER_ITERS,
            "--checkpoint_iterations", VIEWER_ITERS, "--device", dev.type]
    th = threading.Thread(target=client, daemon=True)
    network_gui.serve = spy
    reset_counts()
    th.start()
    try:
        t0 = time.perf_counter()
        out = run_cli(train_lgm_main, argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        network_gui.serve = real_serve
        network_gui.close()
    th.join(timeout=30)
    launches = read_counts()
    gaps = np.diff([t for _, t in stamps[20:VIEWER_CONNECT_AT]])
    step_ms = 1e3 * float(np.median(gaps))
    n_train = len(json.loads((LGM_SCENE / "transforms_train.json").read_text())["frames"])
    n_report = len(views) + min(8, n_train)  # the test views and train[:8]
    expected = only(A=VIEWER_ITERS + n_report + len(requests), B=VIEWER_ITERS, C=VIEWER_ITERS,
                    D=VIEWER_ITERS)
    lgm_ms = 1e3 / MEASURED["lgm_it_s"] if "lgm_it_s" in MEASURED else float("nan")
    say(f"[13 tools] (c) viewer on train_lgm (port {port}): {len(served)} requests served at iteration "
        f"{served[0][2] if served else None}, frames equal to image_to_bytes of the trainer's render "
        f"{[bool(s[0]) for s in served]}, source path {served[0][1] if served else None}; step "
        f"{step_ms:.3f} ms (median, iterations 21-{VIEWER_CONNECT_AT}, listener open, no client) beside "
        f"phase 10's {lgm_ms:.3f} ms (its 3,000-iteration rate); call {wall:.2f} s; launches {launches}")
    if errors or len(served) != len(requests) or not all(s[0] for s in served) \
            or any(s[1] != str(LGM_SCENE) for s in served):
        raise AssertionError(f"viewer: errors {errors}, served {served}")
    if "Training complete." not in out or launches != expected \
            or not (out_dir / f"chkpnt{VIEWER_ITERS}.npz").exists():
        raise AssertionError(f"train_lgm with the viewer did not finish: launches {launches}, "
                             f"expected {expected}")
    return launches


def phase_tools_view(dev) -> dict:
    """(d) `python -m sgs_tpu_torch.view` on the flagship: 24 frames at
    512x512 through Kernel A, each within VIEW_ATOL of the plain render,
    and the GIF's fields."""
    model_dir = TOOLS_DIR / "view_model"
    snap = model_dir / "point_cloud" / "iteration_15000" / "point_cloud.ply"
    snap.parent.mkdir(parents=True)
    shutil.copyfile(FLAGSHIP_PLY, snap)
    out_dir = TOOLS_DIR / "orbit"
    argv = ["-m", model_dir, "--frames", VIEW_FRAMES, "--width", VIEW_SIZE, "--image_height", VIEW_SIZE,
            "--out", out_dir, "--device", dev.type]
    reset_counts()
    t0 = time.perf_counter()
    run_cli(view_cli.main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    args = view_cli.build_parser().parse_args([str(a) for a in argv])
    arrays = load_gaussian_ply(str(snap), SH_DEGREE)
    model = GaussianModel.from_ply(str(snap), SH_DEGREE, dev)
    center = arrays["xyz"].mean(axis=0)
    spread = float(np.abs(arrays["xyz"] - center).max())
    bg = torch.zeros(3, device=dev)
    worst, a_ms = 0.0, []
    with torch.no_grad():
        inputs = model.render_inputs(SH_DEGREE)
        for i, cam in enumerate(view_cli.orbit_cameras(center, spread, args, dev)):
            img = render(cam, inputs, bg, mode="tiled")["render"]
            with plain_path():
                ref = render(cam, inputs, bg, mode="tiled")["render"]
            worst = max(worst, float((img - ref).abs().max()))
            frame = read_png(str(out_dir / f"frame_{i:03d}.png"))
            if not np.array_equal(frame, (np.clip(img.cpu().numpy().transpose(1, 2, 0), 0, 1) * 255)
                                  .astype(np.uint8)):
                raise AssertionError(f"view frame {i} is not the quantised Kernel A render")
            if i in (0, VIEW_FRAMES // 4):
                _, kargs = raster_inputs(project_and_shade(cam, inputs), cam.image_width, cam.image_height)
                a_bound = exp_bounds.kernel_a(kargs, flat_raster.rasterize_tiles(*kargs)[2])
                a_ms.append((time_ms(lambda: flat_raster.rasterize_tiles(*kargs), 20), kargs[2].shape[0],
                             int((kargs[1] - kargs[0]).max()), a_bound))
    gif = read_gif_info(str(out_dir / "orbit.gif"))
    say(f"[13 tools] (d) view CLI: {VIEW_FRAMES} frames at {VIEW_SIZE}x{VIEW_SIZE} in {wall:.2f} s "
        f"(the GIF included), launches {launches}; every frame within {worst:.2e} of the plain render "
        f"(bar {VIEW_ATOL}); Kernel A device ms on frames 0 and {VIEW_FRAMES // 4}: "
        + ", ".join(f"{t:.4f} ({n} instances, longest tile list {m}; bound {b['bound_ms']:.4f} ms, "
                    f"{b['bound_by']}, {b['P']:.0f} instance-pixel pairs)" for t, n, m, b in a_ms)
        + f"; orbit.gif {gif}")
    if launches != only(A=VIEW_FRAMES) or worst > VIEW_ATOL:
        raise AssertionError(f"view: launches {launches}, worst {worst}")
    if gif != {"header": "GIF89a", "size": (VIEW_SIZE, VIEW_SIZE), "loop": 0,
               "delays_ms": [120] * VIEW_FRAMES, "frames": VIEW_FRAMES}:
        raise AssertionError(f"orbit.gif fields {gif}")
    MEASURED["view_a_ms"] = a_ms
    return launches


def phase_tools_scenes(dev) -> dict:
    """(e) data/lgm400 regenerated by the ray tracer and held to the
    committed files; a 128x128 toy Blender scene through the oracle, then
    200 training iterations on it."""
    dst = TOOLS_DIR / "lgm400"
    t0 = time.perf_counter()
    make_raytraced_dataset(str(dst), **LGM_RAYTRACE)
    rt_s = time.perf_counter() - t0
    flips = pixels = worst = 0
    names = sorted(p.relative_to(LGM_SCENE) for p in LGM_SCENE.glob("*/*.png"))
    for rel in names:
        a = read_png(str(LGM_SCENE / rel)).astype(np.int16)
        b = read_png(str(dst / rel)).astype(np.int16)
        d = np.abs(a - b)
        worst = max(worst, int(d.max()))
        flips += int((d.max(axis=2) > 0).sum())
        pixels += d.shape[0] * d.shape[1]
    xyz_err = float(np.abs(load_point_cloud_ply(str(dst / "points3d.ply"))[0]
                           - load_point_cloud_ply(str(LGM_SCENE / "points3d.ply"))[0]).max())
    same_json = all((dst / f).read_text() == (LGM_SCENE / f).read_text()
                    for f in ("transforms_train.json", "transforms_test.json"))
    say(f"[13 tools] (e) ray tracer: data/lgm400 regenerated ({len(names)} views at "
        f"{LGM_RAYTRACE['width']}x{LGM_RAYTRACE['height']}) in "
        f"{rt_s:.2f} s: largest byte difference {worst}, {flips} of {pixels} pixels differ "
        f"(bar: 1 LSB on under {RAYTRACE_FLIP_SHARE:.1%}), points3d.ply within {xyz_err:.1e}, JSON equal "
        f"{same_json}")
    if len(names) != LGM_RAYTRACE["n_train"] + LGM_RAYTRACE["n_test"] or worst > 1 or flips > RAYTRACE_FLIP_SHARE * pixels or xyz_err > RAYTRACE_XYZ_ATOL \
            or not same_json:
        raise AssertionError("the regenerated data/lgm400 differs from the committed one")

    toy = TOOLS_DIR / "toy128"
    reset_counts()
    t0 = time.perf_counter()
    make_blender_dataset(str(toy), width=BLENDER_SIZE, height=BLENDER_SIZE, device=dev)
    toy_s = time.perf_counter() - t0
    if read_counts() != only():
        raise AssertionError(f"the oracle launched kernels: {read_counts()}")
    out_dir = TOOLS_DIR / "train_toy"
    argv = ["-s", toy, "-m", out_dir, "--eval", "-w", "--iterations", BLENDER_ITERS,
            "--test_iterations", 1, BLENDER_ITERS, "--save_iterations", BLENDER_ITERS,
            "--checkpoint_iterations", BLENDER_ITERS, "--device", dev.type]
    t0 = time.perf_counter()
    out = run_cli(train_main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    rows = [r.split("\t") for r in (out_dir / "losses.tsv").read_text().strip().splitlines()[1:]]
    (_, l1_0, psnr_0, _), (_, l1_1, psnr_1, _) = rows
    rate = [ln for ln in out.splitlines() if ln.startswith("Trained ")]
    say(f"[13 tools] (e) toy Blender scene (16 + 4 views at {BLENDER_SIZE}x{BLENDER_SIZE}, the oracle's "
        f"GT) written in {toy_s:.2f} s; {BLENDER_ITERS} iterations: test L1 {float(l1_0):.5f} -> "
        f"{float(l1_1):.5f}, PSNR {float(psnr_0):.3f} -> {float(psnr_1):.3f}; "
        f"{rate[0] if rate else 'no rate line'}; call {wall:.2f} s; launches {launches}")
    steps = BLENDER_ITERS
    reports = 2 * (4 + 25)  # the 4 test views and train views 5..29 at each report
    if not float(l1_1) < float(l1_0) or launches != only(A=steps + reports, B=steps, C=steps, D=steps):
        raise AssertionError(f"toy training: L1 {l1_0} -> {l1_1}, launches {launches}")
    return launches


def phase_tools_analyze(dev) -> None:
    """(f) `python -m sgs_tpu_torch.analyze_model` on the flagship: JAX's
    printed lines, and the PCA PLYs reload."""
    out = TOOLS_DIR / "analysis"
    reset_counts()
    t0 = time.perf_counter()
    printed = run_cli(analyze_main, ["--ply", FLAGSHIP_PLY, "--out", out, "--device", dev.type])
    wall = time.perf_counter() - t0
    lines = [ln for ln in printed.splitlines() if ln]
    n_flagship = load_gaussian_ply(str(FLAGSHIP_PLY), SH_DEGREE)["xyz"].shape[0]
    counts = []
    for tag in ("unnorm", "normal"):
        a = load_gaussian_ply(str(out) + f"_ply_{tag}/point_cloud.ply", SH_DEGREE)
        # the xyz are the model's; an opacity of 1 turns to inf in the
        # inverse sigmoid, in JAX's analyze_model.py as here
        counts.append(int(a["xyz"].shape[0]) if np.isfinite(a["xyz"]).all() else -1)
    say(f"[13 tools] (f) analyze_model: {lines} (JAX {JAX_ANALYZE_LINES}); PCA PLYs reload with "
        f"{counts} Gaussians; {sorted(p.name for p in out.iterdir())}; {wall:.2f} s; "
        f"launches {read_counts()}")
    if lines != JAX_ANALYZE_LINES or counts != [n_flagship, n_flagship] or read_counts() != only():
        raise AssertionError(f"analyze_model: {lines}, {counts}")


def phase_tools(dev) -> dict:
    """Phase 13: the JPEG decoder, the JPEG COLMAP flagship, the viewer,
    view, the scene generators and analyze_model; returns A-D's launches
    summed over its runs."""
    t0 = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    walls = {}
    phase_tools_jpeg()
    walls["a"] = time.perf_counter() - t0
    total = only()
    for part, run in (("b", phase_tools_jpeg_scene), ("c", phase_tools_viewer), ("d", phase_tools_view),
                      ("e", phase_tools_scenes), ("f", phase_tools_analyze)):
        t1 = time.perf_counter()
        launches = run(dev) or only()
        walls[part] = time.perf_counter() - t1
        total = {k: total[k] + launches[k] for k in total}
    say(f"[13 tools] phase wall {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"({k}) {v:.2f}" for k, v in walls.items()) + f"); launches over (b)-(e) {total}")
    return total


def check_close(name: str, got, want, rtol: float, atol: float) -> float:
    """got against want (same non-finite elements, the rest within rtol and
    atol); returns the largest |err|."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{name}: non-finite elements differ")
    err = (got[fin] - want[fin]).abs()
    if not bool((err <= rtol * want[fin].abs() + atol).all()):
        raise AssertionError(f"{name}: max |err| {float(err.max())} over rtol {rtol}, atol {atol}")
    return float(err.max()) if err.numel() else 0.0


def phase_parallel_bands(dev, model, view) -> dict:
    """(a) The flagship view as 8 row bands on one card, equal and balanced:
    each band composited by Kernel A and differentiated by Kernel C, the
    bands stitched and held to the full frame's image and gradients."""
    cam, gt = view.camera, view.gt_image
    bg = torch.zeros(3, device=dev)
    w, h = cam.image_width, cam.image_height
    with torch.no_grad():
        full_img = render(cam, model.render_inputs(SH_DEGREE), bg)["render"]
    want = step_grads(model, cam, gt, bg)
    p = project_and_shade(cam, model.render_inputs(SH_DEGREE))
    _, full_args, full_bargs, _, _ = step_kernel_inputs(model.render_inputs(SH_DEGREE), cam, gt, bg)
    full_a = time_ms(lambda: flat_raster.rasterize_tiles(*full_args), 10)
    full_c = time_ms(lambda: flat_raster.rasterize_tiles_backward(*full_bargs), 10)
    dc_full = full_bargs[9]
    hist = tile_shard.row_load_histogram(p["mean2d"], p["radius"], p["valid"], w, h).cpu().numpy()
    layouts = {"equal": (*hybrid.equal_band_offsets(h, PARALLEL_BANDS), False),
               "balanced": (*tile_shard.balanced_band_offsets(hist, PARALLEL_BANDS), True)}
    total = only()
    for name, (offsets, pad, own) in layouts.items():
        leaves = {f: getattr(model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
        tap = torch.zeros((model.capacity, 3), device=dev, requires_grad=True)
        reset_counts()
        rec, _, _ = tile_shard.splat_records(leaves, model.alive, cam, SH_DEGREE, tap)
        img, auxes = hybrid.render_bands(rec, offsets, pad, w, h, bg, own=own)
        loss = ssim_ops.training_loss(img, gt, 0.2)
        grads = torch.autograd.grad(loss, [leaves[f] for f in PARAM_FIELDS] + [tap])
        torch.cuda.synchronize()
        launches = read_counts()
        if launches != only(A=PARALLEL_BANDS, B=1, C=PARALLEL_BANDS, D=1):
            raise AssertionError(f"(a) {name} bands: launches {launches}, expected A and C once a band")
        total = {k: total[k] + launches[k] for k in total}
        img_err = check_close(f"(a) {name} stitched image", img.detach(), full_img, 0.0, BAND_ATOL)
        errs = {}
        for f, g in zip(PARAM_FIELDS + ("tap",), grads):
            g, wv = (g[:, :2], want[f][:, :2]) if f == "tap" else (g, want[f])
            errs[f] = check_close(f"(a) {name} gradient {f}", g, wv, BAND_GRAD_RTOL, BAND_GRAD_ATOL)
        # each band's Kernel A and C alone on the arguments its render gave
        # them, C on the band's rows of the loss's cotangent
        band_ms = []
        for off, aux in zip(offsets, auxes):
            args, bins = aux["args"], aux["bins"]
            dc = torch.zeros((3, pad * TILE, w), device=dev)
            rows = dc_full[:, int(off) * TILE:int(off) * TILE + pad * TILE]
            dc[:, :rows.shape[1]] = rows
            bargs = (*args, aux["t_final"], aux["n_contrib"], dc, bg, bins["perm"], bins["rank_start"],
                     bins["order"])
            band_ms.append((time_ms(lambda: flat_raster.rasterize_tiles(*args), 10),
                            time_ms(lambda: flat_raster.rasterize_tiles_backward(*bargs), 10)))
        worst = max(range(len(band_ms)), key=lambda i: band_ms[i][0] + band_ms[i][1])
        say(f"[14 parallel] (a) {name} bands: offsets (tile rows) {[int(o) for o in offsets]}, {pad} tile rows "
            f"each ({pad * TILE} px); launches {launches} (A and C once a band); instances per band "
            f"{[a['n_instances'] for a in auxes]} (full frame {full_args[2].shape[0]}); stitched image within "
            f"{img_err:.2e} of Kernel A's full render (bar {BAND_ATOL}); gradients max |err| "
            + ", ".join(f"{f} {v:.2e}" for f, v in errs.items())
            + f" (rtol {BAND_GRAD_RTOL}, atol {BAND_GRAD_ATOL}); device ms A / C per band "
            + ", ".join(f"{a:.4f} / {c:.4f}" for a, c in band_ms)
            + f"; worst band {worst}: A {band_ms[worst][0]:.4f}, C {band_ms[worst][1]:.4f} against the full "
              f"frame's A {full_a:.4f}, C {full_c:.4f}")
    return total


def seeded_state(model, seed: int = 0) -> TrainState:
    """The model with seeded Adam moments (step 40) and statistics, so a
    step is not Adam's sign-like first one."""
    rng = np.random.default_rng(seed)
    dev = model.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    params = model.params()
    adam = AdamState(mu={f: t(rng.normal(0, 1e-4, v.shape)) for f, v in params.items()},
                     nu={f: t(rng.uniform(1e-9, 1e-7, v.shape)) for f, v in params.items()},
                     step={f: 40 for f in params})
    cap = model.capacity
    stats = DensifyStats(xyz_gradient_accum=t(rng.uniform(0, 1e-3, (cap, 1))),
                         denom=t(rng.integers(0, 20, (cap, 1))), max_radii2d=t(rng.uniform(0, 30, cap)))
    return TrainState(model=model, adam=adam, stats=stats)


def check_state(label: str, got: TrainState, gm: dict, want: TrainState, wm: dict) -> float:
    """A parallel step's state and metrics against `train_step`'s at
    tests/test_torch_train_step.py's bars; returns the worst |err| / scale."""
    if abs(float(gm["loss"]) - float(wm["loss"])) > 1e-5 * abs(float(wm["loss"])):
        raise AssertionError(f"{label}: loss {float(gm['loss'])} against {float(wm['loss'])}")
    if int(gm["nonfinite_grads"]) != int(wm["nonfinite_grads"]):
        raise AssertionError(f"{label}: nonfinite_grads {int(gm['nonfinite_grads'])} "
                             f"against {int(wm['nonfinite_grads'])}")
    pairs = [(f, getattr(got.model, f), getattr(want.model, f)) for f in PARAM_FIELDS]
    pairs += [(f"mu {f}", got.adam.mu[f], want.adam.mu[f]) for f in PARAM_FIELDS]
    pairs += [(f"nu {f}", got.adam.nu[f], want.adam.nu[f]) for f in PARAM_FIELDS]
    pairs += [(k, getattr(got.stats, k), getattr(want.stats, k))
              for k in ("xyz_gradient_accum", "denom", "max_radii2d")]
    worst = 0.0
    for name, g, wv in pairs:
        scale = float(wv.abs().max())
        err = check_close(f"{label} {name}", g, wv, STEP_RTOL, STEP_ATOL_SCALE * scale)
        worst = max(worst, err / max(scale, 1e-30))
    return worst


def phase_parallel_nccl(dev, model, view) -> dict:
    """(b) One `make_dp_train_step` and one 1x1 `make_hybrid_train_step` in a
    one-rank NCCL group of this process, against `train_step` on the view."""
    import torch.distributed as dist

    cam, gt = view.camera, view.gt_image
    bg = torch.zeros(3, device=dev)
    rank_dev = mesh_lib.init_distributed("cuda")
    try:
        backend = dist.get_backend()
        state = seeded_state(model)
        lrs = make_lr_dict(OptimizationParams(), scene_extent(), 7000)
        want, wm = train_step(state, cam, gt, bg, lrs, SH_DEGREE)
        mesh = mesh_lib.make_mesh((1,), ("data",), "cuda")
        cam_b, gt_b = data_parallel.shard_camera_batch(data_parallel.stack_cameras([cam]), gt[None], mesh)
        total = only()
        results = {}
        hmesh = mesh_lib.make_mesh((1, 1), ("data", "gauss"), "cuda")
        runs = (("dp", lambda: data_parallel.make_dp_train_step(mesh, SH_DEGREE)(state, cam_b, gt_b, bg, lrs)),
                ("hybrid 1x1", lambda: hybrid.make_hybrid_train_step(hmesh, SH_DEGREE, cam.image_width,
                                                                     cam.image_height, compact=True)(
                    hybrid.place_hybrid_state(state, hmesh), cam_b, gt_b, bg, lrs)))
        for name, run in runs:
            reset_counts()
            got, gm = run()
            torch.cuda.synchronize()
            launches = read_counts()
            if launches != only(A=1, B=1, C=1, D=1):
                raise AssertionError(f"(b) {name}: launches {launches}")
            total = {k: total[k] + launches[k] for k in total}
            results[name] = check_state(f"(b) {name}", got, gm, want, wm)
        say(f"[14 parallel] (b) a one-rank {backend} group on {rank_dev}: "
            + "; ".join(f"{k} step against train_step, worst |err| / field max {v:.2e}" for k, v in results.items())
            + f" (rtol {STEP_RTOL}, atol {STEP_ATOL_SCALE} x max; loss {float(wm['loss']):.6f}, nonfinite_grads "
              f"{int(wm['nonfinite_grads'])}); launches A-D once each a step")
    finally:
        dist.destroy_process_group()
    return total


def train_cli_run(out_dir: Path, mode: str, nproc: int) -> tuple:
    """The train CLI from points3d.ply: `--parallel none` as a plain
    process, dp/hybrid under torchrun with `nproc` ranks. Returns
    (losses.tsv rows, wall s)."""
    argv = ["-s", FLAGSHIP_SCENE, "-m", out_dir, "--eval", "--iterations", PARALLEL_ITERS,
            "--densify_from_iter", 20, "--densification_interval", 15, "--densify_until_iter", 39,
            "--test_iterations", 20, PARALLEL_ITERS, "--save_iterations", PARALLEL_ITERS,
            "--checkpoint_iterations", -1, "--parallel", mode]
    launcher = [sys.executable]
    if mode != "none":
        launcher += ["-m", "torch.distributed.run", f"--nproc_per_node={nproc}", "--master_port",
                     str(mesh_lib.free_port())]
    cmd = launcher + ["-m", "sgs_tpu_torch.train"] + [str(a) for a in argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"{' '.join(cmd)} exited {res.returncode}:\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
    rows = [r.split("\t") for r in (out_dir / "losses.tsv").read_text().strip().splitlines()[1:]]
    return rows, wall


def phase_parallel_cli(dev) -> None:
    """(c) `torchrun --nproc_per_node=1 -m sgs_tpu_torch.train --parallel dp`
    against `--parallel none` with the same seed: the same losses.tsv rows.
    With two cards or more, dp and hybrid also run on every card."""
    none_rows, none_wall = train_cli_run(PARALLEL_DIR / "none", "none", 1)
    dp_rows, dp_wall = train_cli_run(PARALLEL_DIR / "dp1", "dp", 1)
    if len(none_rows) != 2 or [r[0] for r in dp_rows] != [r[0] for r in none_rows]:
        raise AssertionError(f"(c) rows {dp_rows} against {none_rows}")
    worst = 0.0
    for got, want in zip(dp_rows, none_rows):
        if got[3] != want[3]:
            raise AssertionError(f"(c) Gaussian count {got[3]} against {want[3]} at iteration {got[0]}")
        for g, wv in zip(got[1:3], want[1:3]):
            err = abs(float(g) - float(wv))
            worst = max(worst, err / abs(float(wv)))
            if err > STEP_RTOL * abs(float(wv)):
                raise AssertionError(f"(c) dp row {got} against none {want}")
    if not float(dp_rows[1][1]) < float(dp_rows[0][1]):
        raise AssertionError(f"(c) the test L1 did not fall: {dp_rows}")
    say(f"[14 parallel] (c) {PARALLEL_ITERS} iterations from points3d.ply through one densify: torchrun "
        f"--nproc_per_node=1 --parallel dp rows {dp_rows} against --parallel none {none_rows}, worst relative "
        f"difference {worst:.2e} (bar {STEP_RTOL}); walls {dp_wall:.2f} / {none_wall:.2f} s (scene load and "
        f"process start included)")
    n = torch.cuda.device_count()
    if n < 2:
        say(f"[14 parallel] (b), (c) with more than one rank: not run, this machine has {n} card "
            "(NCCL puts one rank on a card); the many-rank paths are checked on the CPU with gloo")
        return
    for mode in ("dp", "hybrid"):
        rows, wall = train_cli_run(PARALLEL_DIR / f"{mode}{n}", mode, n)
        if len(rows) != 2 or not float(rows[1][1]) < float(rows[0][1]):
            raise AssertionError(f"(c) {mode} over {n} ranks: rows {rows}")
        say(f"[14 parallel] (c) torchrun --nproc_per_node={n} --parallel {mode}: rows {rows}, wall {wall:.2f} s")


def phase_parallel(dev, model, view) -> dict:
    """Phase 14: the band render on one card, the one-rank NCCL steps and
    the CLI under torchrun; returns A-D's launches over (a) and (b)."""
    t0 = time.perf_counter()
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    PARALLEL_DIR.mkdir(parents=True)
    walls = {}
    a = phase_parallel_bands(dev, model, view)
    walls["a"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    b = phase_parallel_nccl(dev, model, view)
    walls["b"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    phase_parallel_cli(dev)
    walls["c"] = time.perf_counter() - t1
    total = {k: a[k] + b[k] for k in a}
    say(f"[14 parallel] phase wall {time.perf_counter() - t0:.2f} s ("
        + ", ".join(f"({k}) {v:.2f}" for k, v in walls.items()) + f"); launches over (a)-(b) {total}")
    return total


def phase_rect(dev, model, view) -> dict:
    """Phase 15: the tiled rasterizer without tight culling
    (`--no-tight_culling`, rect binning) on flagship test view 0 with
    phase 5's model: (a) the view rendered with both binnings, the rect
    image held to the tight one within RECT_IMAGE_ATOL, each binning's
    instances and A's and C's device ms on its arguments; (b) 10 steps of
    the train CLI with --no-tight_culling from phase 5's checkpoint: A-D
    once a step, the snapshot's fields beside phase 5's. Returns A-D's
    launches over (a) and (b)."""
    t0 = time.perf_counter()
    cam, gt = view.camera, view.gt_image
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        inputs = model.render_inputs(SH_DEGREE)
        reset_counts()
        tight = render(cam, inputs, bg, mode="tiled")
        rect = render(cam, inputs, bg, mode="rect")
        torch.cuda.synchronize()
        a_launches = read_counts()
    if a_launches != only(A=2):
        raise AssertionError(f"(a) launches {a_launches}, expected A twice")
    err = float((rect["render"] - tight["render"]).abs().max())
    if not err <= RECT_IMAGE_ATOL:
        raise AssertionError(f"(a) rect-binned image off the tight one by {err:.3e} (bar {RECT_IMAGE_ATOL})")
    ms = {}
    for name, is_tight in (("tight", True), ("rect", False)):
        _, args, bargs, _, _ = step_kernel_inputs(inputs, cam, gt, bg, is_tight)
        ms[name] = {"A": time_ms(lambda: flat_raster.rasterize_tiles(*args), 10),
                    "C": time_ms(lambda: flat_raster.rasterize_tiles_backward(*bargs), 10)}
    say(f"[15 rect] (a) test view 0: rect image against tight max |err| {err:.3e} (bar {RECT_IMAGE_ATOL}); "
        f"instances tight {tight['n_instances']}, rect {rect['n_instances']} "
        f"(x{rect['n_instances'] / tight['n_instances']:.3f}); device ms A tight {ms['tight']['A']:.4f} / rect "
        f"{ms['rect']['A']:.4f}, C tight {ms['tight']['C']:.4f} / rect {ms['rect']['C']:.4f}")
    steps = TRAIN_TO - TRAIN_FROM
    argv = ["-s", FLAGSHIP_SCENE, "-m", RECT_DIR, "--eval", "--start_checkpoint",
            TRAIN_DIR / "flagship_29990.npz", "--iterations", TRAIN_TO, "--test_iterations", -1,
            "--checkpoint_iterations", -1, "--no-tight_culling", "--device", dev.type]
    reset_counts()
    t1 = time.perf_counter()
    run_cli(train_main, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    b_launches = read_counts()
    if b_launches != only(A=steps, B=steps, C=steps, D=steps):
        raise AssertionError(f"(b) training launches {b_launches}, expected {steps} of each kernel")
    snaps = [load_gaussian_ply(str(d / "point_cloud" / f"iteration_{TRAIN_TO}" / "point_cloud.ply"), SH_DEGREE)
             for d in (RECT_DIR, TRAIN_DIR)]
    if snaps[0]["xyz"].shape != snaps[1]["xyz"].shape or not np.isfinite(snaps[0]["xyz"]).all():
        raise AssertionError(f"(b) snapshot of {snaps[0]['xyz'].shape[0]} Gaussians against "
                             f"{snaps[1]['xyz'].shape[0]}")
    diffs = {f: float(np.abs(snaps[0][f] - snaps[1][f]).max() / max(np.abs(snaps[1][f]).max(), 1e-30))
             for f in PARAM_FIELDS}
    say(f"[15 rect] (b) {steps} steps with --no-tight_culling from phase 5's checkpoint: launches {b_launches}; "
        "snapshot against phase 5's (tight), max |diff| / field max: "
        + ", ".join(f"{f} {v:.2e}" for f, v in diffs.items()) + f"; trainer call {wall:.2f} s; "
        f"phase wall {time.perf_counter() - t0:.2f} s")
    return {k: a_launches[k] + b_launches[k] for k in a_launches}


def check_bench_counts(label: str, got: dict, want: dict) -> str:
    """The card's binning counts against JAX's: equal, or within
    BENCH_COUNT_RTOL of the count (any difference is printed)."""
    diffs = {k: got[k] - want[k] for k in want}
    bad = {k: d for k, d in diffs.items() if abs(d) > BENCH_COUNT_RTOL * want[k]}
    if bad:
        raise AssertionError(f"{label} counts {got} differ from JAX's {want}: {bad}")
    off = {k: d for k, d in diffs.items() if d}
    return f"equal to JAX's {want}" if not off else f"JAX's {want} but for {off}"


def l1_kernel_args(bins, args, bg) -> tuple:
    """Kernel C's arguments for Kernel A's arguments `args`: A's t_final and
    n_contrib and the cotangent of the benchmark loss (L1 against zeros)."""
    color, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    image = (color + t_final[None] * bg[:, None, None]).requires_grad_(True)
    (dc,) = torch.autograd.grad(ssim_ops.l1_loss(image, torch.zeros_like(image)), image)
    return (*args, t_final, n_contrib, dc.contiguous(), bg, bins["perm"], bins["rank_start"],
            bins["order"])


def sample_tiles(bins, args, tiles: torch.Tensor) -> tuple:
    """(bins, A's args) with every tile's list but those of `tiles` emptied,
    the instances of the kept lists in their order, and C's presort
    permutation and runs renumbered over the kept instances."""
    tile_start, tile_end, point_list = args[0].long(), args[1].long(), args[2]
    keep_tile = torch.zeros_like(tile_start, dtype=torch.bool)
    keep_tile[tiles.long()] = True
    counts = torch.where(keep_tile, tile_end - tile_start, 0)
    owner = torch.repeat_interleave(torch.arange(tile_start.shape[0], device=tile_start.device),
                                    tile_end - tile_start)
    keep = keep_tile[owner]
    presort_keep = torch.zeros_like(keep)
    presort_keep[bins["perm"][keep]] = True
    renumber = torch.cumsum(presort_keep.long(), 0) - 1
    cs = torch.cat([renumber.new_zeros(1), renumber + 1])
    end = torch.cumsum(counts, 0)
    sub = dict(bins, perm=renumber[bins["perm"][keep]].contiguous(),
               rank_start=cs[bins["rank_start"]].contiguous())
    sub_args = ((end - counts).to(torch.int32).contiguous(), end.to(torch.int32).contiguous(),
                point_list[keep].contiguous(), *args[3:])
    return sub, sub_args


def bench_kernels(label: str, bins, args, bg) -> dict:
    """Kernel A's, C's and C's walk's device ms on the main path's
    arguments, printed beside their bounds (`exp_bounds.kernel_a`,
    `c_bounds`)."""
    bargs = l1_kernel_args(bins, args, bg)
    a_row = exp_bounds.kernel_a(args, bargs[8])
    walk_bound, _, c_bound = c_bounds(bargs)
    inst = torch.empty((bargs[2].shape[0], flat_raster.N_GRADS), device=bg.device)
    out = {"A": time_ms(lambda: flat_raster.rasterize_tiles(*args), 10),
           "C": time_ms(lambda: flat_raster.rasterize_tiles_backward(*bargs), 10),
           "C walk": time_ms(lambda: flat_raster.raster_backward_walk(bargs, inst), 10)}
    say(f"[16 bench] {label}: device ms A {out['A']:.4f} (bound {a_row['bound_ms']:.4f}, "
        f"{a_row['bound_by']}; x{out['A'] / a_row['bound_ms']:.1f}), C {out['C']:.4f} (bound "
        f"{c_bound[0]:.4f}, {c_bound[1]}; x{out['C'] / c_bound[0]:.1f}), C's walk {out['C walk']:.4f} "
        f"(bound {walk_bound[0]:.4f}, {walk_bound[1]}; x{out['C walk'] / walk_bound[0]:.1f}); "
        f"{float(bargs[8].sum()):.0f} instance-pixel pairs below n_contrib")
    return out


def bench_stages(label: str, model, cam, kernels: dict, loss_step, n_profile: int) -> None:
    """One forward+backward of the benchmark split into stages, as phase 5
    splits the training step (`host_stages`; A and C from `kernels`,
    device ms); then `profile_steps` over `n_profile` calls of
    `loss_step`."""
    stages = {**host_stages(model, cam, 3), "A": kernels["A"], "C": kernels["C"]}
    say(f"[16 bench] {label} stages: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f" ms (sum {sum(stages.values()):.3f} ms)")
    profile_steps(loss_step, n_profile, f"[16 profile] {label}")


def phase_bench_flagship(dev) -> dict:
    """Phase 16 (a): the flagship at 1920x1080 with bench.py's framing
    through `bench.measure` (ITERS forward+backward steps and ITERS
    renders, each after a warm-up), launches counted; the render-only
    image equal to the forward+backward image; A and C against their plain
    versions over the whole frame, bit for bit, with the benchmark loss's
    cotangent; the counts against JAX's; A's and C's ms against their
    bounds; the step's stages and device busy share. Returns A's and C's
    launches."""
    width, height = BENCH_SIZE
    model, cam = bench.build_ply_scene(FLAGSHIP_PLY, width, height, dev)
    counts = bench_scale.scene_counts(model, cam)
    said = check_bench_counts("(a)", counts, JAX_BENCH_COUNTS["flagship"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    r = bench.measure(model, cam)
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    want = only(A=2 * (bench.ITERS + 1), C=bench.ITERS + 1)
    if launches != want:
        raise AssertionError(f"(a) launches {launches}, expected {want}")
    if not torch.equal(r["image"], r["render_image"]):
        raise AssertionError("(a) the render-only image differs from the forward+backward image")
    say(f"[16 bench] (a) flagship at {width}x{height} ({model.num_alive} Gaussians in "
        f"{model.capacity} slots): counts {counts}, {said}; {bench.ITERS} forward+backward steps "
        f"{r['fwd_bwd_ms']:.3f} ms each ({r['fps']:.3f} frames/s), {bench.ITERS} renders "
        f"{r['render_ms']:.3f} ms each ({r['render_fps']:.3f} frames/s); loss {float(r['loss']):.6f}; "
        f"peak {peak:.3f} GiB; launches {launches}; render-only image equal to the "
        "forward+backward image")
    bg = torch.zeros(3, device=dev)
    with torch.no_grad():
        p = project_and_shade(cam, model.render_inputs(SH_DEGREE))
    bins, args = raster_inputs(p, width, height)
    compare_raster(args)
    bargs = l1_kernel_args(bins, args, bg)
    compare_raster_backward(bargs)
    plain_ms = {}
    for k, fn in (("A", lambda: flat_raster.rasterize_tiles_plain(*args)),
                  ("C", lambda: flat_raster.rasterize_tiles_backward_plain(*bargs))):
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        plain_ms[k] = (time.perf_counter() - t1) * 1e3
    say(f"[16 bench] (a) A and C over the whole frame ({args[2].shape[0]} instances, longest list "
        f"{counts['longest_list']}) equal to their plain versions bit for bit; one plain call (host "
        f"clock) A {plain_ms['A']:.1f} ms, C {plain_ms['C']:.1f} ms")
    ms = bench_kernels(f"(a) flagship {width}x{height}", bins, args, bg)
    gt = torch.zeros((3, height, width), device=dev)
    bench_stages("(a)", model, cam, ms, lambda: bench_scale.loss_and_grads(model, cam, gt, bg), 5)
    return launches


def phase_bench_scale(dev) -> dict:
    """Phase 16 (b): the 5M panning capture (`tools/bench_scale.py`'s
    scene, BASELINE's garden scale) at 1920x1080: two forward+backward
    calls of the benchmark loss, launches counted, loss and every
    gradient finite and the same bits in both; the counts, and those of
    the all-visible view of the same pool, against JAX's; A and C against
    their plain versions on the BENCH_SAMPLE_TILES longest lists and as
    many drawn from the other non-empty lists (every other list emptied);
    A's and C's ms on the whole frame against their bounds; the stages and
    device busy share. Returns A's and C's launches."""
    width, height = BENCH_SIZE
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, cam = bench_scale.scale_scene(BENCH_N, True, width, height, dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    counts = bench_scale.scene_counts(model, cam)
    said = check_bench_counts("(b)", counts, JAX_BENCH_COUNTS["capture"])
    all_cam = bench_scale.bench_camera([0.0, 0.0, 4.5], width, height, dev)
    all_counts = bench_scale.scene_counts(model, all_cam)
    all_said = check_bench_counts("(b) all-visible", all_counts, JAX_BENCH_COUNTS["all_visible"])
    gt = torch.zeros((3, height, width), device=dev)
    bg = torch.zeros(3, device=dev)
    reset_counts()
    runs, wall = [], []
    for _ in range(2):
        t1 = time.perf_counter()
        runs.append(bench_scale.loss_and_grads(model, cam, gt, bg))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if launches != only(A=2, C=2):
        raise AssertionError(f"(b) launches {launches}, expected A and C twice")
    (loss, image, n_inst, grads), (loss2, image2, _, grads2) = runs
    finite = bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads.values())
    if not finite or n_inst != counts["instances"]:
        raise AssertionError(f"(b) loss {float(loss)}, finite gradients {finite}, "
                             f"{n_inst} instances against {counts['instances']} counted")
    same = torch.equal(loss, loss2) and torch.equal(image, image2) and all(
        torch.equal(grads[f], grads2[f]) for f in grads)
    if not same:
        raise AssertionError("(b) two forward+backward calls differ")
    say(f"[16 bench] (b) {BENCH_N} Gaussians, panning capture at {width}x{height}: scene built in "
        f"{build_s:.2f} s; counts {counts}, {said}; all-visible view {all_counts}, {all_said}; two "
        f"forward+backward calls {wall[0]:.1f} / {wall[1]:.1f} ms (host clock), loss "
        f"{float(loss):.6f}, every gradient finite, the same bits in both; peak {peak:.3f} GiB; "
        f"launches {launches}")
    del runs, loss, image, grads, loss2, image2, grads2
    with torch.no_grad():
        p = project_and_shade(cam, model.render_inputs(SH_DEGREE))
    bins, args = raster_inputs(p, width, height)
    lengths = (args[1] - args[0]).long()
    longest = torch.argsort(lengths, descending=True, stable=True)[:BENCH_SAMPLE_TILES]
    rest = lengths > 0
    rest[longest] = False
    g = torch.Generator(device="cpu").manual_seed(BENCH_SAMPLE_SEED)
    others = torch.nonzero(rest).flatten().cpu()
    drawn = others[torch.randperm(others.shape[0], generator=g)[:BENCH_SAMPLE_TILES]].to(dev)
    sub, sub_args = sample_tiles(bins, args, torch.cat([longest, drawn]))
    compare_raster(sub_args)
    compare_raster_backward(l1_kernel_args(sub, sub_args, bg))
    say(f"[16 bench] (b) A and C on {2 * BENCH_SAMPLE_TILES} tiles ({BENCH_SAMPLE_TILES} longest: "
        f"lists {lengths[longest].tolist()}; {BENCH_SAMPLE_TILES} drawn with seed "
        f"{BENCH_SAMPLE_SEED}: {lengths[drawn].tolist()}; {sub_args[2].shape[0]} instances) equal "
        "to their plain versions bit for bit")
    ms = bench_kernels(f"(b) {BENCH_N} capture {width}x{height}", bins, args, bg)
    del bins, args, sub, sub_args
    bench_stages("(b)", model, cam, ms, lambda: bench_scale.loss_and_grads(model, cam, gt, bg), 3)
    return launches


def phase_bench(dev) -> dict:
    """Phase 16: (a) and (b); returns A's and C's launches over both."""
    t0 = time.perf_counter()
    a = phase_bench_flagship(dev)
    b = phase_bench_scale(dev)
    say(f"[16 bench] phase wall {time.perf_counter() - t0:.2f} s")
    return {k: a[k] + b[k] for k in a}


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
    readers = phase_readers(dev)
    evals = phase_eval(dev, views)
    tools = phase_tools(dev)
    parallel = phase_parallel(dev, model, views[0])
    rect = phase_rect(dev, model, views[0])
    del model
    benched = phase_bench(dev)
    for entry, k in zip(kernels, "ABCD"):
        entry["readers_launches"] = readers[k]
        entry["tools_launches"] = tools[k]
        entry["parallel_launches"] = parallel[k]
        entry["rect_launches"] = rect[k]
        if k in "AB":
            entry["eval_launches"] = evals["launches"][k]
        if k in "AC":
            entry["bench_launches"] = benched[k]
    say(f"[17 done] chip_smoke wall {time.perf_counter() - t_start:.2f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
