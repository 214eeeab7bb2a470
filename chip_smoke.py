#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`sgs_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each:
  1. device: the card's name and power limit (nvidia-smi) and torch's name;
  2. build: both CUDA kernels built cold from `sgs_tpu_torch/csrc/`, one
     nvcc per source, started together;
  3. kernels against their plain PyTorch versions on the card: Kernel A
     (raster forward) on a seeded random scene with an empty tile, a
     saturated tile and a width that is not a multiple of 16; Kernel B
     (SSIM forward) at three sizes, plus a run-to-run bitwise check;
  4. the slice: the port's render and metrics entry points on the trained
     flagship model (assets/flagship/point_cloud.ply) and the 8-view test
     split of data/flagship800, held per view to the JAX package's
     committed numbers (assets/flagship/per_view.json, results.json). The
     launch counts are reset just before and read just after. Then each
     view is timed with CUDA events;
  5. a `{"kernels": [...]}` line, the device line, and last the result
     line `{"ok": true, "device": {...}}`.

Any failed phase raises and the script exits nonzero. It needs the
repository around it and a CUDA device; without either it fails before
printing a result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.core.projection import TILE, tile_rect
from sgs_tpu_torch.data.readers import read_nerf_synthetic_split
from sgs_tpu_torch.metrics import evaluate, read_image
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.ops import build, flat_raster, ssim as ssim_ops
from sgs_tpu_torch.render.cli import render_sets
from sgs_tpu_torch.render.pipeline import project_and_shade, render
from sgs_tpu_torch.render.tiled import bin_gaussians, kernel_args
from sgs_tpu_torch.train.loop import eval_render

ROOT = Path(__file__).resolve().parent
FLAGSHIP_PLY = ROOT / "assets" / "flagship" / "point_cloud.ply"
FLAGSHIP_SCENE = ROOT / "data" / "flagship800"
FLAGSHIP_PER_VIEW = ROOT / "assets" / "flagship" / "per_view.json"
FLAGSHIP_RESULTS = ROOT / "assets" / "flagship" / "results.json"
SMOKE_DIR = ROOT / "build" / "smoke" / "flagship"
METHOD = "ours_15000"
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
    build.build_all([flat_raster.KERNEL, ssim_ops.KERNEL])
    total = time.perf_counter() - t0
    for k in (flat_raster.KERNEL, ssim_ops.KERNEL):
        regs = [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln]
        say(f"[2 build] {k.source.name}: {k.build_seconds if k.build_seconds is not None else 0.0:.2f} s "
            f"(cached: {k.build_seconds is None}) {' | '.join(regs)}")
    say(f"[2 build] both kernels ready in {total:.2f} s")


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
    errs_b = []
    for i, (h, w) in enumerate([(37, 53), (64, 128), (800, 800)]):
        x, y = ssim_pair(h, w, i, dev)
        errs_b.append(compare_ssim(x, y))
        say(f"[3 kernels] B ssim forward {h}x{w}: |err| {errs_b[-1]:.3g} "
            f"(rtol {SSIM_RTOL}, atol {SSIM_ATOL}), bitwise repeatable")
    return {"A": err_a, "B": max(errs_b)}


def phase_slice(dev) -> dict:
    per_view = json.loads(FLAGSHIP_PER_VIEW.read_text())[METHOD]
    results = json.loads(FLAGSHIP_RESULTS.read_text())[METHOD]
    flat_raster.KERNEL.launches = 0
    ssim_ops.KERNEL.launches = 0
    t0 = time.perf_counter()
    render_sets(str(SMOKE_DIR), str(FLAGSHIP_SCENE), ply=str(FLAGSHIP_PLY), iteration=15000,
                white_background=WHITE_BACKGROUND, sh_degree=SH_DEGREE, skip_train=True, device=dev)
    got = evaluate([str(SMOKE_DIR)], device=dev)[str(SMOKE_DIR)][METHOD]
    torch.cuda.synchronize()
    launches = {"A": flat_raster.KERNEL.launches, "B": ssim_ops.KERNEL.launches}
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
    if launches["A"] != n_views or launches["B"] != 2 * n_views:
        raise AssertionError(f"main path launches {launches}, expected A {n_views}, B {2 * n_views}")
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


def phase_timing(dev, errs: dict, launches: dict) -> list:
    model = GaussianModel.from_ply(str(FLAGSHIP_PLY), SH_DEGREE, dev)
    views = read_nerf_synthetic_split(str(FLAGSHIP_SCENE), "test", WHITE_BACKGROUND, -1, dev)
    bg = torch.zeros(3, device=dev)
    tot = {"inst": 0, "render": 0.0, "ssim": 0.0, "A": 0.0, "B": 0.0}
    first = None
    for i, v in enumerate(views):
        out = render(v.camera, model.render_inputs(SH_DEGREE), bg)
        gt = read_image(SMOKE_DIR / "test" / METHOD / "gt" / f"{i:05d}.png", dev)
        q = read_image(SMOKE_DIR / "test" / METHOD / "renders" / f"{i:05d}.png", dev)
        render_ms = time_cuda(lambda: eval_render(model, v.camera, bg, SH_DEGREE), 5)
        ssim_ms = time_cuda(lambda: ssim_ops.ssim(q, gt), 50)
        shade_ms = time_cuda(lambda: project_and_shade(v.camera, model.render_inputs(SH_DEGREE)), 5)
        p = project_and_shade(v.camera, model.render_inputs(SH_DEGREE))
        w, h = v.camera.image_width, v.camera.image_height
        bin_ms = time_cuda(lambda: raster_inputs(p, w, h), 5)
        _, args = raster_inputs(p, w, h)
        a_ms = time_cuda(lambda: flat_raster.rasterize_tiles(*args), 20)
        b_ms = time_cuda(lambda: ssim_ops.ssim_forward(q, gt), 50)
        say(f"[4 timing] view {i}: {out['n_instances']} instances, render {render_ms:.3f} ms "
            f"(project+shade {shade_ms:.3f}, binning {bin_ms:.3f}, kernel A {a_ms:.3f}), "
            f"ssim {ssim_ms:.3f} ms (kernel B {b_ms:.3f})")
        tot["inst"] += out["n_instances"]
        tot["render"] += render_ms
        tot["ssim"] += ssim_ms
        tot["A"] += a_ms
        tot["B"] += b_ms
        if first is None:
            first = {"args": args, "q": q, "gt": gt, "a_ms": a_ms, "b_ms": b_ms}
    say(f"[4 timing] total over {len(views)} views: {tot['inst']} instances, render {tot['render']:.3f} ms, "
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
    lib_b_ms = time_cuda(lambda: conv2d_ssim(q, gt, w1d), 50)
    lib_err = abs(float(conv2d_ssim(q, gt, w1d)) - float(ssim_ops.ssim_plain(q, gt)))
    h, w = q.shape[1:]
    n_part = 3 * (-(-h // ssim_ops.TILE)) * (-(-w // ssim_ops.TILE))
    b_bound, b_by = bound_ms(2 * 4 * 3 * h * w + 2 * 4 * n_part + 4, ssim_ops.OPS_PER_PIXEL * 3 * h * w)
    say(f"[4 timing] view 0: plain A {plain_a_ms:.3f} ms, plain B {plain_b_ms:.3f} ms, "
        f"conv2d SSIM {lib_b_ms:.3f} ms (|d| {lib_err:.2e})")
    return [
        {"name": "flat_raster_forward", "route": "cuda", "source": "sgs_tpu_torch/csrc/flat_raster.cu",
         "replaces": "sgs_tpu/ops/pallas/flat_raster.py:462", "launches": launches["A"],
         "max_abs_err": errs["A"], "ms": first["a_ms"], "plain_ms": plain_a_ms,
         "bound_ms": a_bound, "bound_by": a_by, "library_ms": None},
        {"name": "ssim_forward", "route": "cuda", "source": "sgs_tpu_torch/csrc/ssim.cu",
         "replaces": "sgs_tpu/ops/pallas/ssim_kernels.py:228", "launches": launches["B"],
         "max_abs_err": errs["B"], "ms": first["b_ms"], "plain_ms": plain_b_ms,
         "bound_ms": b_bound, "bound_by": b_by, "library_ms": lib_b_ms},
    ]


def main() -> int:
    t_start = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda")
    phase_build()
    errs = phase_kernels(dev)
    sl = phase_slice(dev)
    kernels = phase_timing(dev, errs, sl["launches"])
    say(f"[5 done] chip_smoke wall {time.perf_counter() - t_start:.2f} s")
    say(json.dumps({"kernels": kernels}))
    say(smi)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
