#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sgs_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases:
  1. device: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: the four CUDA sources built cold from `sgs_tpu_torch/csrc/`,
     one nvcc per source, started together;
  3. kernels against their plain PyTorch versions on the card: Kernels A
     (raster forward) and C (raster backward) on a seeded random scene
     with an empty tile, a saturated tile and a width that is not a
     multiple of 16, C also run twice for a bitwise check; Kernels B and
     D (SSIM forward and backward) at three sizes, B also twice;
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
     on the same inputs, and one step is split into its stages by CUDA
     events;
  6. training from scratch: 100 iterations from data/flagship800's
     points3d.ply with densification and the test report, which must
     lower the test L1 and change the Gaussian count; the saved PLY is
     rendered through `python -m sgs_tpu_torch.render`;
  7. kernel times against their plain versions, bounds and library calls
     at the main path's shapes (flagship view 0);
  8. a `{"kernels": [...]}` line, the device line, and last the result
     line `{"ok": true, "device": {...}}`.

Any failed phase raises and the script exits nonzero. It needs the
repository around it and a CUDA device; without either it fails before
printing a result.
"""

from __future__ import annotations

import contextlib
import io
import json
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
from sgs_tpu_torch.data.scene import get_nerfpp_norm
from sgs_tpu_torch.metrics import evaluate, read_image
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel, default_capacity
from sgs_tpu_torch.ops import build, flat_raster, ssim as ssim_ops
from sgs_tpu_torch.ops.ssim import l1_loss
from sgs_tpu_torch.render.cli import main as render_main
from sgs_tpu_torch.render.cli import render_sets
from sgs_tpu_torch.render.pipeline import project_and_shade, render
from sgs_tpu_torch.render.tiled import bin_gaussians, kernel_args
from sgs_tpu_torch.train.__main__ import main as train_main
from sgs_tpu_torch.train.checkpoint import save_checkpoint
from sgs_tpu_torch.train.loop import TrainState, eval_render, train_step
from sgs_tpu_torch.train.optim import AdamState, adam_update, make_lr_dict
from sgs_tpu_torch.utils.config import OptimizationParams

ROOT = Path(__file__).resolve().parent
FLAGSHIP_PLY = ROOT / "assets" / "flagship" / "point_cloud.ply"
FLAGSHIP_SCENE = ROOT / "data" / "flagship800"
FLAGSHIP_PER_VIEW = ROOT / "assets" / "flagship" / "per_view.json"
FLAGSHIP_RESULTS = ROOT / "assets" / "flagship" / "results.json"
SMOKE_DIR = ROOT / "build" / "smoke" / "flagship"
TRAIN_DIR = ROOT / "build" / "smoke" / "train_flagship"
SCRATCH_DIR = ROOT / "build" / "smoke" / "train_scratch"
METHOD = "ours_15000"
KERNELS = (flat_raster.KERNEL, ssim_ops.KERNEL, flat_raster.BACKWARD, ssim_ops.BACKWARD)
# the full-width training run: 10 steps to the end of a 30k schedule
TRAIN_FROM, TRAIN_TO = 29_990, 30_000
SCRATCH_ITERS = 100
# The flagship's training config (runs/flagship_r5/cfg_args): black
# background, full resolution, SH degree 3.
WHITE_BACKGROUND = False
SH_DEGREE = 3

# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32
# operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

RASTER_ATOL = 3e-5
SSIM_RTOL, SSIM_ATOL = 1e-5, 1e-6
PSNR_BAR, SSIM_BAR = 0.02, 5e-4
# Kernels C and D against their plain versions: rtol 1e-5 plus an atol of
# 1e-6 of the largest gradient (the same arithmetic in the same order, up
# to the last bits of expf against torch.exp); the training step's
# parameter gradients through the kernels against the plain path's: rtol
# 1e-4 plus 1e-6 of each field's largest gradient.
BWD_RTOL, BWD_ATOL_SCALE = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-6


def say(*parts) -> None:
    print(*parts, flush=True)


def time_cuda(fn, reps: int) -> float:
    """Mean ms of `fn` over `reps` calls after three warm-ups, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def phase_build() -> None:
    t0 = time.perf_counter()
    build.build_all(list(KERNELS))
    total = time.perf_counter() - t0
    for k in KERNELS:
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        say(f"[2 build] {k.source.name}: {k.build_seconds if k.build_seconds is not None else 0.0:.2f} s "
            f"(cached: {k.build_seconds is None}) {' | '.join(regs)}")
    say(f"[2 build] {len(KERNELS)} sources ready in {total:.2f} s")


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def read_counts() -> dict:
    return {"A": flat_raster.KERNEL.launches, "B": ssim_ops.KERNEL.launches,
            "C": flat_raster.BACKWARD.launches, "D": ssim_ops.BACKWARD.launches}


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
    got = flat_raster.rasterize_tiles(*args)
    want = flat_raster.rasterize_tiles_plain(*args)
    torch.cuda.synchronize()
    err_img = float((got[0] - want[0]).abs().max())
    err_t = float((got[1] - want[1]).abs().max())
    if err_img > RASTER_ATOL or err_t > RASTER_ATOL:
        raise AssertionError(f"Kernel A differs from its plain version: image {err_img}, t_final {err_t}")
    if not torch.equal(got[2], want[2]):
        bad = int((got[2] != want[2]).sum())
        raise AssertionError(f"Kernel A n_contrib differs from its plain version at {bad} pixels")
    return max(err_img, err_t)


def ssim_pair(h, w, seed, dev):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.15, x.shape), 0, 1).astype(np.float32)
    return torch.as_tensor(x, device=dev), torch.as_tensor(y, device=dev)


def compare_ssim(x, y) -> float:
    got = ssim_ops.ssim_forward(x, y)
    again = ssim_ops.ssim_forward(x, y)
    want = ssim_ops.ssim_plain(x, y)
    got_v, again_v, want_v = float(got), float(again), float(want)
    if got_v != again_v:
        raise AssertionError(f"Kernel B is not bitwise repeatable: {got_v} vs {again_v}")
    err = abs(got_v - want_v)
    if err > SSIM_ATOL + SSIM_RTOL * abs(want_v):
        raise AssertionError(f"Kernel B {got_v} differs from its plain version {want_v}")
    return err


def backward_args(bins, args, dev, seed):
    """Kernel C's arguments for a binned scene and a seeded cotangent."""
    _, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    g = torch.Generator(device=dev).manual_seed(seed)
    dc = torch.randn((3, args[7], args[6]), generator=g, device=dev)
    bg = torch.rand(3, generator=g, device=dev)
    return (*args, t_final, n_contrib, dc, bg, bins["perm"], bins["rank_start"], bins["order"])


def rel_err(got, want, atol_scale):
    """max |got - want| and whether it is within rtol + atol_scale * max|want|."""
    err = (got - want).abs()
    ok = bool((err <= BWD_RTOL * want.abs() + atol_scale * float(want.abs().max())).all())
    return float(err.max()), ok


def compare_raster_backward(bargs) -> float:
    got = flat_raster.rasterize_tiles_backward(*bargs)
    again = flat_raster.rasterize_tiles_backward(*bargs)
    want = flat_raster.rasterize_tiles_backward_plain(*bargs)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError("Kernel C is not bitwise repeatable")
    err, ok = rel_err(got, want, BWD_ATOL_SCALE)
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"Kernel C differs from its plain version: max |err| {err}")
    return err


def compare_ssim_backward(x, y, cot) -> float:
    got = ssim_ops.ssim_backward(x, y, cot)
    want = ssim_ops.ssim_backward_plain(x, y, cot)
    torch.cuda.synchronize()
    worst = 0.0
    for g, w in zip(got, want):
        err, ok = rel_err(g, w, BWD_ATOL_SCALE)
        if not ok:
            raise AssertionError(f"Kernel D differs from its plain version: max |err| {err}")
        worst = max(worst, err)
    return worst


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
        f"{bins['point_list'].shape[0]} instances, {int((counts == 0).sum())} empty tiles, "
        f"max |err| {err_a:.3g} (atol {RASTER_ATOL}), n_contrib equal")
    err_c = compare_raster_backward(backward_args(bins, args, dev, 1))
    say(f"[3 kernels] C raster backward: same scene, max |err| {err_c:.3g} "
        f"(rtol {BWD_RTOL}, atol {BWD_ATOL_SCALE} x max), bitwise repeatable")
    errs_b, errs_d = [], []
    for i, (h, w) in enumerate([(37, 53), (64, 128), (800, 800)]):
        x, y = ssim_pair(h, w, i, dev)
        errs_b.append(compare_ssim(x, y))
        errs_d.append(compare_ssim_backward(x, y, torch.tensor(0.7, device=dev)))
        say(f"[3 kernels] B ssim forward {h}x{w}: |err| {errs_b[-1]:.3g} "
            f"(rtol {SSIM_RTOL}, atol {SSIM_ATOL}), bitwise repeatable; "
            f"D ssim backward: max |err| {errs_d[-1]:.3g} (rtol {BWD_RTOL}, atol {BWD_ATOL_SCALE} x max)")
    return {"A": err_a, "B": max(errs_b), "C": err_c, "D": max(errs_d)}


def phase_slice(dev) -> dict:
    per_view = json.loads(FLAGSHIP_PER_VIEW.read_text())[METHOD]
    results = json.loads(FLAGSHIP_RESULTS.read_text())[METHOD]
    reset_counts()
    t0 = time.perf_counter()
    render_sets(str(SMOKE_DIR), str(FLAGSHIP_SCENE), ply=str(FLAGSHIP_PLY), iteration=15000,
                white_background=WHITE_BACKGROUND, sh_degree=SH_DEGREE, skip_train=True, device=dev)
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
    if launches != {"A": n_views, "B": n_views, "C": 0, "D": 0}:
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
    if launches != {k: steps for k in "ABCD"}:
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

    # the step's own inputs to Kernels C and D
    p = project_and_shade(cam, model.render_inputs(SH_DEGREE))
    bins, args = raster_inputs(p, w, h)
    color, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
    image = (color + t_final[None] * bg[:, None, None]).requires_grad_(True)
    (dc,) = torch.autograd.grad(ssim_ops.training_loss(image, gt, 0.2), image)
    bargs = (*args, t_final, n_contrib, dc.contiguous(), bg, bins["perm"], bins["rank_start"],
             bins["order"])
    img = image.detach().contiguous()
    cot = torch.tensor(-0.2, device=dev)
    err_c = compare_raster_backward(bargs)
    err_d = compare_ssim_backward(img, gt, cot)
    say(f"[5 step] view 0: gradients through the kernels vs the plain path, max |err| / field max: "
        + ", ".join(f"{f} {v:.2e}" for f, v in worst.items())
        + f" (rtol {GRAD_RTOL}, atol {GRAD_ATOL_SCALE} x max); C max |err| {err_c:.3g}, "
          f"D max |err| {err_d:.3g}")

    # stages of one step, CUDA events, means over the reps
    leaves = {f: getattr(model, f).detach().requires_grad_(True) for f in PARAM_FIELDS}
    grad_model = model.with_params(leaves)
    stages = {}
    stages["projection+SH"] = time_cuda(lambda: project_and_shade(cam, grad_model.render_inputs(SH_DEGREE)), 5)
    stages["binning"] = time_cuda(lambda: raster_inputs(p, w, h), 5)
    stages["A"] = time_cuda(lambda: flat_raster.rasterize_tiles(*args), 10)
    stages["B"] = time_cuda(lambda: ssim_ops.ssim_forward(img, gt), 20)
    stages["C+reduction"] = time_cuda(lambda: flat_raster.rasterize_tiles_backward(*bargs), 10)
    stages["D"] = time_cuda(lambda: ssim_ops.ssim_backward(img, gt, cot), 20)
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
        + f" ms (sum {sum(stages.values()):.3f} ms)")
    profile_steps(lambda: train_step(state, cam, gt, bg, lrs, SH_DEGREE))
    return {"bargs": bargs, "img": img, "gt": gt, "cot": cot, "C": err_c, "D": err_d,
            "c_ms": stages["C+reduction"], "d_ms": stages["D"], "stages": stages, "step_ms": step_ms}


def profile_steps(step, n: int = 5) -> None:
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
        say("[5 profile] device busy share: not measured (no device events recorded)")
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
    say(f"[5 profile] {n} steps: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
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
    run_cli(render_main, ["-m", SCRATCH_DIR, "--skip_train", "--device", dev.type])
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
        a_ms = time_cuda(lambda: flat_raster.rasterize_tiles(*args), 10)
        b_ms = time_cuda(lambda: ssim_ops.ssim_forward(q, gt), 20)
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
    n = args[3].shape[0]
    m = args[2].shape[0]
    hw = args[6] * args[7]
    a_bytes = 4 * m + 36 * n + 8 * args[0].shape[0] + 20 * hw
    a_bound, a_by = bound_ms(a_bytes, flat_raster.OPS_PER_PAIR * float(n_contrib.sum()))

    q, gt = first["q"], first["gt"]
    errs["B"] = max(errs["B"], compare_ssim(q, gt))
    plain_b_ms = time_cuda(lambda: ssim_ops.ssim_plain(q, gt), 5)
    w1d = ssim_ops.gaussian_window().to(dev)
    lib_b_ms = time_cuda(lambda: conv2d_ssim(q, gt, w1d), 20)
    lib_err = abs(float(conv2d_ssim(q, gt, w1d)) - float(ssim_ops.ssim_plain(q, gt)))
    h, w = q.shape[1:]
    n_part = 3 * (-(-h // ssim_ops.TILE)) * (-(-w // ssim_ops.TILE))
    b_bound, b_by = bound_ms(2 * 4 * 3 * h * w + 2 * 4 * n_part + 4, ssim_ops.OPS_PER_PIXEL * 3 * h * w)

    # Kernels C and D on the training step's inputs (phase 5, view 0)
    bargs = step["bargs"]
    t0 = time.perf_counter()
    flat_raster.rasterize_tiles_backward_plain(*bargs)
    torch.cuda.synchronize()
    plain_c_ms = (time.perf_counter() - t0) * 1e3
    n, m = bargs[3].shape[0], bargs[2].shape[0]
    hw = bargs[6] * bargs[7]
    c_bytes = (4 * m + 8 * m + 8 * bargs[0].shape[0] + 36 * n + 20 * hw + 12
               + 8 * (n + 1) + 8 * n + 4 * flat_raster.N_GRADS * n)
    c_bound, c_by = bound_ms(c_bytes, flat_raster.OPS_PER_PAIR_BWD * float(bargs[9].sum()))
    img, sgt, cot = step["img"], step["gt"], step["cot"]
    plain_d_ms = time_cuda(lambda: ssim_ops.ssim_backward_plain(img, sgt, cot), 3)
    xg = img.clone().requires_grad_(True)
    lib_out = conv2d_ssim(xg, sgt, w1d)
    lib_d_ms = time_cuda(lambda: torch.autograd.grad(lib_out, xg, retain_graph=True), 20)
    d_bound, d_by = bound_ms(4 * 4 * 3 * hw + 4, ssim_ops.OPS_PER_PIXEL_BWD * 3 * hw)
    say(f"[7 timing] view 0: plain A {plain_a_ms:.3f} ms, plain B {plain_b_ms:.3f} ms, "
        f"conv2d SSIM {lib_b_ms:.3f} ms (|d| {lib_err:.2e}); kernel C {step['c_ms']:.3f} ms, "
        f"plain C {plain_c_ms:.3f} ms; kernel D {step['d_ms']:.3f} ms, plain D {plain_d_ms:.3f} ms, "
        f"conv2d SSIM backward {lib_d_ms:.3f} ms")
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


def main(device: str = "cuda") -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device(device)
    phase_build()
    errs = phase_kernels(dev)
    phase_slice(dev)
    model = flagship_model(dev)
    train = phase_train_flagship(dev, model)
    views = read_nerf_synthetic_split(str(FLAGSHIP_SCENE), "test", WHITE_BACKGROUND, -1, dev)
    step = phase_step(dev, model, views[0])
    errs["C"] = max(errs["C"], step["C"])
    errs["D"] = max(errs["D"], step["D"])
    phase_scratch(dev)
    kernels = phase_timing(dev, errs, train["launches"], views, step)
    say(f"[8 done] chip_smoke wall {time.perf_counter() - t_start:.2f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
