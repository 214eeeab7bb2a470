"""Scaling benchmark: forward+backward frame time at 1920x1080 against
the Gaussian count. Port of `scripts/bench_scale.py`.

    python -m sgs_tpu_torch.tools.bench_scale [--capture] [--device D] [N ...]

The scene is the JAX script's: a pool of N Gaussians with converged-capture
statistics (points drawn around the origin, splat linear size shrinking
as N^(-1/3), so the covered area stays about constant as the pool
densifies), the same numpy draws from `default_rng(0)` in the same order,
seen at 1920x1080 from (0, 0, 4.5), or with `--capture` from (2.5, 0,
4.5): a panning capture view in which about half the pool leaves the
frustum. The default sweep is 100k, 500k, 1M, 2M and 5M, BASELINE.json's
garden-scale configuration at the top. One JSON line per configuration.

`run_config` keeps the JAX script's keys. `visible`, `rows` and
`instances` are the binning's real counts (`scene_counts`); the port has
no static buckets, so `capacity` and `max_visible` are null. `compile_s`
is the wall time of the first forward+backward call, kernel builds
included (the port compiles nothing else). `fwd_bwd_ms` is the mean of
`ITERS` calls of `l1_loss(render(...), zeros)` and its backward after one
warm-up call, by CUDA events around the calls (the path syncs the host
in its binning, so this is the frame time a caller sees); no call keeps
an earlier call's outputs alive. The port adds `longest_list` (the
longest tile list), `render_ms` (no-grad renders, timed the same way),
`peak_gib` (`torch.cuda.max_memory_allocated` over the configuration,
scene included) and `device`. On the CPU (`--device cpu`, a dry run) the
times and memory are null: they are not measured there.

Kept out of the port, JAX-only: the count pre-passes that size JAX's
static buckets and the `max_visible` compaction that `--capture` turns on
there (with `--no_vis`): the port sizes every array from the real counts.
A failure raises; nothing is caught.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.core.projection import focal2fov, fov2focal
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.ops.ssim import l1_loss
from sgs_tpu_torch.render.pipeline import project_and_shade, render
from sgs_tpu_torch.render.tiled import bin_gaussians
from sgs_tpu_torch.tools.ssim_times import time_ms

WIDTH, HEIGHT = 1920, 1080
ITERS = 4
SWEEP = [100_000, 500_000, 1_000_000, 2_000_000, 5_000_000]
SH_DEGREE = 3


def bench_camera(position, width: int, height: int, device) -> Camera:
    """The benchmarks' camera: identity rotation, 60 degrees across, the
    vertical field of view from the same focal length, `position` the
    world-to-view translation."""
    fovx = math.radians(60)
    fovy = focal2fov(fov2focal(fovx, width), height)
    return Camera.from_Rt(np.eye(3), np.array(position), fovx, fovy, width, height, device=device)


def scale_scene(n: int, capture: bool, width: int = WIDTH, height: int = HEIGHT,
                device: "str | torch.device" = "cuda") -> tuple:
    """(model, camera): the JAX script's scene of `n` Gaussians
    (`scripts/bench_scale.py:49-85`), built on `device` from numpy."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    pts = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    cols = rng.uniform(size=(n, 3)).astype(np.float32)
    # knn_dist2 is given, so the pool never reaches the knn; the scales it
    # sets are replaced below
    model = GaussianModel.from_pcd(pts, cols, SH_DEGREE, capacity=n,
                                   knn_dist2=np.full((n,), 1e-4, np.float32), device=dev)
    del pts, cols
    shrink = math.log((n / 100_000.0) ** (1.0 / 3.0))
    log_s = rng.uniform(-5.2 - shrink, -3.6 - shrink, (n, 3)).astype(np.float32)
    opac_logit = rng.uniform(-1.0, 4.0, (n, 1)).astype(np.float32)
    model.scaling.copy_(torch.from_numpy(log_s))
    model.opacity.copy_(torch.from_numpy(opac_logit))
    position = [2.5, 0.0, 4.5] if capture else [0.0, 0.0, 4.5]
    return model, bench_camera(position, width, height, dev)


@torch.no_grad()
def scene_counts(model: GaussianModel, camera: Camera) -> dict:
    """The binning's counts for one view (tight culling, as the render
    path bins): visible Gaussians (valid and a positive radius), (Gaussian,
    tile-row) rows, (Gaussian, tile) instances and the longest tile list."""
    p = project_and_shade(camera, model.render_inputs(SH_DEGREE))
    bins = bin_gaussians(p["mean2d"], p["conic"], p["opacity"], p["depth"], p["radius"],
                         p["valid"], camera.image_width, camera.image_height)
    return {
        "visible": int((p["valid"] & (p["radius"] > 0)).sum()),
        "rows": bins["n_rows"],
        "instances": int(bins["point_list"].shape[0]),
        "longest_list": int((bins["tile_end"] - bins["tile_start"]).max()),
    }


def loss_and_grads(model: GaussianModel, camera: Camera, gt: torch.Tensor,
                   bg: torch.Tensor) -> tuple:
    """One forward+backward of the benchmark loss, L1 against `gt`:
    (loss, image, instances, the gradient of every parameter field)."""
    leaves = {f: p.detach().requires_grad_(True) for f, p in model.params().items()}
    out = render(camera, model.with_params(leaves).render_inputs(SH_DEGREE), bg)
    loss = l1_loss(out["render"], gt)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), out["render"].detach(), out["n_instances"], dict(zip(leaves, grads))


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def run_config(n: int, capture: bool = False, width: int = WIDTH, height: int = HEIGHT,
               device: "str | torch.device" = "cuda", iters: int = ITERS) -> dict:
    """Build the scene of `n` Gaussians, count its bins, then time
    forward+backward and render-only frames (module docstring)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    model, cam = scale_scene(n, capture, width, height, dev)
    counts = scene_counts(model, cam)
    gt = torch.zeros((3, height, width), dtype=torch.float32, device=dev)
    bg = torch.zeros(3, dtype=torch.float32, device=dev)

    def fwd_bwd():
        return loss_and_grads(model, cam, gt, bg)

    t0 = time.perf_counter()
    loss, _, n_instances, _ = fwd_bwd()
    if on_card:
        torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    if n_instances != counts["instances"] or not math.isfinite(float(loss)):
        raise RuntimeError(f"render binned {n_instances} instances (counted {counts['instances']}), "
                           f"loss {float(loss)}")
    fwd_bwd()  # warm-up
    fwd_bwd_ms = time_ms(fwd_bwd, iters, hide_host=False, warmup=0) if on_card else None

    def view():
        with torch.no_grad():
            render(cam, model.render_inputs(SH_DEGREE), bg)

    view()
    render_ms = time_ms(view, iters, hide_host=False, warmup=0) if on_card else None
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if on_card else None
    return {
        "n_gaussians": n,
        "visible": counts["visible"],
        "max_visible": None,
        "instances": counts["instances"],
        "rows": counts["rows"],
        "capacity": None,
        "fwd_bwd_ms": None if fwd_bwd_ms is None else round(fwd_bwd_ms, 2),
        "fps": None if fwd_bwd_ms is None else round(1e3 / fwd_bwd_ms, 3),
        "compile_s": round(compile_s, 1),
        "capture": capture,
        "longest_list": counts["longest_list"],
        "render_ms": None if render_ms is None else round(render_ms, 2),
        "peak_gib": None if peak is None else round(peak, 3),
        "device": device_name(dev),
    }


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ns", nargs="*", type=float, help="pool sizes (default: the sweep)")
    p.add_argument("--capture", action="store_true", help="the panning capture view")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(sys.argv[1:] if argv is None else argv)
    results = []
    for n in [int(x) for x in args.ns] or SWEEP:
        r = run_config(n, capture=args.capture, device=args.device)
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
