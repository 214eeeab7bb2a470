"""Times the reference rasterizer (the O(N*P) oracle) per view beside the
tiled path, at several pixel blocks.

    python -m sgs_tpu_torch.tools.oracle_times [--blocks 16384 65536 ...] [--scenes flagship lgm]
        [--view 0] [--device cuda]

Renders a test view (--view, 0 by default) of the flagship
(assets/flagship/point_cloud.ply on data/flagship800, 800x800) and of the
LGM snapshot
(assets/lgm/point_cloud.ply on data/lgm400, 400x400) with
`render(mode="reference")` at each pixel block and with
`render(mode="tiled")` (binning and Kernel A). Prints per view and block
the ms of one render (host clock around synchronised calls, the first
call not timed), the peak device memory, the valid count N, the N*P pair
tests, their rate and the largest difference from the tiled image; then
each pixel over the image bar (3e-5) with why it differs
(`explain_pixels`); then one JSON line and the card's name and power
limit.

The oracle and Kernel A compute alpha with JAX's two arrangements of the
conic's quadratic form (the reference's -0.5 (a dx^2 + c dy^2) - b dx dy,
the tiled (-0.5 a dx - b dy) dx - 0.5 c dy^2) and order their products
differently (a cumulative product per chunk against a running product).
At a needle-shaped splat seen far from its centre the two arrangements
round apart by about 1e-4 of alpha, which can move a pixel past the bar
or flip a 1/255 or 1e-4 test. `explain_pixels` replays each such pixel in
f32 with each arrangement over the oracle's depth order and rectangle
tests (no binning), and says whether that accounts for both images and
whether binning dropped a Gaussian the pixel needs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.core.projection import ALPHA_MAX, ALPHA_MIN, TILE, TRANSMITTANCE_EPS, tile_rect
from sgs_tpu_torch.data.camera_utils import read_nerf_synthetic_split
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.ops.exp_forward import CUT_T_WINDOW
from sgs_tpu_torch.render.pipeline import project_and_shade, render
from sgs_tpu_torch.render.tiled import bin_gaussians

IMAGE_ATOL = 3e-5

ROOT = Path(__file__).resolve().parents[2]
SCENES = {
    "flagship": (ROOT / "assets" / "flagship" / "point_cloud.ply", ROOT / "data" / "flagship800", 3),
    "lgm": (ROOT / "assets" / "lgm" / "point_cloud.ply", ROOT / "data" / "lgm400", 0),
}
BLOCKS = (16384, 65536, 262144, 640000)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def view_ms(fn, dev, reps: int = 2) -> float:
    """Mean ms of `fn` over `reps` calls after one warm-up."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(dev)
    return (time.perf_counter() - t0) * 1e3 / reps


def _sequential(ids, a, rgb) -> torch.Tensor:
    """A pixel's colour composited one Gaussian at a time, in f32, with the
    stop before the one that would take T below 1e-4: Kernel A's loop."""
    T = torch.ones((), dtype=torch.float32, device=rgb.device)
    C = torch.zeros(3, dtype=torch.float32, device=rgb.device)
    for g, al in zip(ids.tolist(), a.tolist()):
        al = torch.tensor(al, dtype=torch.float32, device=rgb.device)
        t_test = T * (1.0 - al)
        if t_test < TRANSMITTANCE_EPS:
            break
        C = C + rgb[g] * (al * T)
        T = t_test
    return C


def explain_pixels(p: dict, bins: dict, image: torch.Tensor, tiled: torch.Tensor,
                   atol: float = IMAGE_ATOL) -> list:
    """Why the oracle's `image` and Kernel A's `tiled` differ by more than
    `atol` at each pixel where they do, from `project_and_shade`'s output
    `p` and `bins`, the tile lists of `render/tiled.py::bin_gaussians`.
    Each pixel's sequence is replayed one Gaussian at a time in f32 in the
    oracle's depth order with its tile-rectangle tests (no binning), once
    with each of JAX's two arrangements of the conic's quadratic form:
    `seq_oracle` with the oracle's, `seq_a` with Kernel A's. Also:
    - `t`: the least |T_after - 1e-4| over the sequence in float64 up to
      its stop;
    - `flips`: Gaussians live (power <= 0, alpha >= 1/255, in their
      rectangle) under one arrangement and not the other;
    - `dropped`: Gaussians live under both that the pixel's tile list
      lacks (what binning culled);
    - `explained`: nothing dropped, Kernel A's pixel within `atol` of
      `seq_a` and the oracle's within `atol` of `seq_oracle` (or its
      transmittance within CUT_T_WINDOW of the stop, where the oracle's
      cumulative product and a running product may stop one Gaussian
      apart): the two images then differ only by the two arrangements'
      rounding, which at a needle-shaped splat far from its centre (terms
      of thousands cancelling to a power of a few) moves alpha by about
      1e-4 of itself."""
    height, width = image.shape[1:]
    valid = p["valid"]
    order = torch.argsort(torch.where(valid, p["depth"], float("inf")), stable=True)[:int(valid.sum())]
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    rect = torch.stack(tile_rect(p["mean2d"], p["radius"].to(torch.float32), tiles_x, tiles_y), -1)[order]
    m2d, conic, opac = p["mean2d"][order], p["conic"][order], p["opacity"][order]
    out = []
    for idx in torch.nonzero((image - tiled).abs().amax(dim=0).flatten() > atol)[:, 0].tolist():
        x, y = idx % width, idx // width
        in_rect = ((x // TILE >= rect[:, 0]) & (x // TILE < rect[:, 1])
                   & (y // TILE >= rect[:, 2]) & (y // TILE < rect[:, 3]))
        live, alphas = {}, {}
        for name, dt in (("oracle", torch.float32), ("a", torch.float32), ("f64", torch.float64)):
            dx, dy, c, op = m2d[:, 0].to(dt) - x, m2d[:, 1].to(dt) - y, conic.to(dt), opac.to(dt)
            if name == "a":
                power = (-0.5 * c[:, 0] * dx - c[:, 1] * dy) * dx + (-0.5 * c[:, 2]) * dy * dy
            else:
                power = -0.5 * (c[:, 0] * dx * dx + c[:, 2] * dy * dy) - c[:, 1] * dx * dy
            alphas[name] = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
            live[name] = (power <= 0) & (alphas[name] >= ALPHA_MIN) & in_rect
        a64 = torch.where(live["f64"], alphas["f64"], 0.0)
        t_after = torch.cumprod(1.0 - a64, 0)
        viol = torch.nonzero((a64 > 0) & (t_after < TRANSMITTANCE_EPS))
        stop = int(viol[0]) if viol.numel() else a64.shape[0] - 1
        tested = torch.arange(a64.shape[0], device=a64.device) <= stop
        t = (t_after - TRANSMITTANCE_EPS).abs()[tested & (a64 > 0)]
        t_m = float(t.min()) if t.numel() else float("inf")
        tile = (y // TILE) * tiles_x + x // TILE
        in_list = torch.zeros_like(valid)
        in_list[bins["point_list"][bins["tile_start"][tile]:bins["tile_end"][tile]].long()] = True
        seq = {k: _sequential(order[live[k]], alphas[k][live[k]], p["rgb"]) for k in ("oracle", "a")}
        px = {"oracle": image[:, y, x], "a": tiled[:, y, x]}
        dev_o, dev_a = (float((px[k] - seq[k]).abs().max()) for k in ("oracle", "a"))
        dropped = order[tested & live["oracle"] & live["a"] & ~in_list[order]].tolist()
        out.append({"pixel": (x, y), "oracle_px": px["oracle"].tolist(), "tiled_px": px["a"].tolist(),
                    "seq_oracle": seq["oracle"].tolist(), "seq_a": seq["a"].tolist(), "t": t_m,
                    "flips": order[tested & (live["oracle"] != live["a"])].tolist(), "dropped": dropped,
                    "explained": not dropped and dev_a <= atol and (dev_o <= atol or t_m <= CUT_T_WINDOW)})
    return out


def oracle_view(model: GaussianModel, camera, sh_degree: int, dev, blocks, reps: int = 2) -> dict:
    """The oracle's ms per view at each pixel block against the tiled
    path's, its pair tests and its largest difference from the tiled image."""
    bg = torch.zeros(3, device=dev)
    inputs = model.render_inputs(sh_degree)
    with torch.no_grad():
        n_valid = int(project_and_shade(camera, inputs)["valid"].sum())
        tiled = render(camera, inputs, bg, mode="tiled")["render"]
        out = {"n_valid": n_valid, "pixels": camera.image_width * camera.image_height,
               "tiled_ms": view_ms(lambda: render(camera, inputs, bg, mode="tiled"), dev, 5),
               "blocks": {}}
        out["pairs"] = out["n_valid"] * out["pixels"]
        image = render(camera, inputs, bg, mode="reference")["render"]
        p = project_and_shade(camera, inputs)
        bins = bin_gaussians(p["mean2d"], p["conic"], p["opacity"], p["depth"], p["radius"], p["valid"],
                             camera.image_width, camera.image_height)
        out["over_bar"] = explain_pixels(p, bins, image, tiled)
        for block in blocks:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            image = render(camera, inputs, bg, mode="reference", pixel_block=block)["render"]
            ms = view_ms(lambda: render(camera, inputs, bg, mode="reference", pixel_block=block),
                         dev, reps)
            out["blocks"][block] = {
                "ms": ms, "pairs_per_s": out["pairs"] / ms * 1e3,
                "max_abs_diff_tiled": float((image - tiled).abs().max()),
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else None,
            }
    return out


def run(dev, blocks=BLOCKS, reps: int = 2, scenes=tuple(SCENES), view: int = 0) -> dict:
    result = {}
    for name in scenes:
        ply, scene, sh_degree = SCENES[name]
        model = GaussianModel.from_ply(str(ply), sh_degree, dev)
        camera = read_nerf_synthetic_split(str(scene), "test", False, -1, dev)[view].camera
        r = oracle_view(model, camera, sh_degree, dev, blocks, reps)
        for block, b in r["blocks"].items():
            print(f"[oracle] {name} test view {view} ({camera.image_width}x{camera.image_height}, N {r['n_valid']}, "
                  f"{r['pairs']:.4g} pair tests): pixel block {block}: {b['ms']:.3f} ms "
                  f"({b['pairs_per_s']:.4g} pairs/s, peak {b['peak_gib']} GiB), "
                  f"|oracle - tiled| {b['max_abs_diff_tiled']:.2e}; tiled {r['tiled_ms']:.3f} ms", flush=True)
        print(f"[oracle] {name}: {len(r['over_bar'])} pixels over {IMAGE_ATOL}, explained by the "
              f"arithmetic: {sum(m['explained'] for m in r['over_bar'])}", flush=True)
        for m in r["over_bar"][:40]:
            print(f"[oracle]   {m}", flush=True)
        result[name] = r
    return result


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--blocks", type=int, nargs="+", default=list(BLOCKS))
    parser.add_argument("--reps", type=int, default=2)
    parser.add_argument("--scenes", nargs="+", default=list(SCENES), choices=list(SCENES))
    parser.add_argument("--view", type=int, default=0, help="test view index")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    print(json.dumps(run(dev, args.blocks, args.reps, args.scenes, args.view)))
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
