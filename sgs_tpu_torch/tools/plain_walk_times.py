"""Wall time of Kernel A's plain version (`ops/flat_raster.py::
rasterize_tiles_plain`) on `view`'s orbit frames of the flagship, or on
its test view 0, against another checkout's plain version, in turns.

    python -m sgs_tpu_torch.tools.plain_walk_times [--parent <checkout>] [--frames 24] [--view0 --reps 3]

The frames are `chip_smoke.py` phase 13 (d)'s: `python -m
sgs_tpu_torch.view`'s defaults (24 frames at 512x512 around
assets/flagship/point_cloud.ply); `--view0` takes data/flagship800's test
view 0 at 800x800 instead (phase 7's plain A), `--reps` times. Each frame
is projected and binned once; then this tree's plain walk and the
parent's (its `ops/flat_raster.py` loaded by path) run on the same
arguments in turns (parent, this, this, parent on alternate frames), each
must give the same bits, and the seconds of each are printed as one JSON
line. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import importlib.util
import json
import time
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
FLAGSHIP_PLY = ROOT / "assets" / "flagship" / "point_cloud.ply"
FLAGSHIP_SCENE = ROOT / "data" / "flagship800"


def load_plain(checkout: Path):
    """`rasterize_tiles_plain` of another checkout's `ops/flat_raster.py`."""
    spec = importlib.util.spec_from_file_location(
        "parent_flat_raster", checkout / "sgs_tpu_torch" / "ops" / "flat_raster.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.rasterize_tiles_plain


def frame_args(dev, frames: int, size: int, view0: bool = False) -> list:
    """Kernel A's arguments for each orbit frame, or for test view 0."""
    from sgs_tpu_torch import view as view_cli
    from sgs_tpu_torch.data.ply import load_gaussian_ply
    from sgs_tpu_torch.models.gaussians import GaussianModel
    from sgs_tpu_torch.render.pipeline import project_and_shade
    from sgs_tpu_torch.render.tiled import bin_gaussians, kernel_args

    arrays = load_gaussian_ply(str(FLAGSHIP_PLY), 3)
    model = GaussianModel.from_ply(str(FLAGSHIP_PLY), 3, dev)
    center = arrays["xyz"].mean(axis=0)
    spread = float(np.abs(arrays["xyz"] - center).max())
    if view0:
        from sgs_tpu_torch.core.camera import Camera
        from sgs_tpu_torch.data.readers import read_cameras_from_transforms

        info = read_cameras_from_transforms(str(FLAGSHIP_SCENE), "transforms_test.json", False, device=dev)[0]
        cams = [Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, info.width, info.height, dev)]
    else:
        args = view_cli.build_parser().parse_args(
            ["-m", "unused", "--frames", str(frames), "--width", str(size), "--image_height", str(size)])
        cams = view_cli.orbit_cameras(center, spread, args, dev)
    out = []
    with torch.no_grad():
        inputs = model.render_inputs(3)
        for cam in cams:
            size_x, size_y = cam.image_width, cam.image_height
            p = project_and_shade(cam, inputs)
            bins = bin_gaussians(p["mean2d"], p["conic"], p["opacity"], p["depth"], p["radius"], p["valid"],
                                 size_x, size_y)
            out.append(kernel_args(bins, p["mean2d"], p["conic"], p["opacity"], p["rgb"], size_x, size_y))
    return out


def timed(fn, args, dev) -> tuple:
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def run(dev, frames: int = 24, size: int = 512, parent: "Path | None" = None, view0: bool = False,
        reps: int = 1) -> dict:
    from sgs_tpu_torch.ops import flat_raster

    walks = {"this": flat_raster.rasterize_tiles_plain}
    if parent is not None:
        walks = {"parent": load_plain(parent), **walks}
    secs = {k: [] for k in walks}
    longest = []
    with torch.no_grad():
        turns = [a for a in frame_args(dev, frames, size, view0) for _ in range(reps)]
        for i, args in enumerate(turns):
            names = list(walks) if i % 2 == 0 else list(walks)[::-1]
            results = {}
            for k in names:
                results[k], s = timed(walks[k], args, dev)
                secs[k].append(s)
            for k, res in results.items():
                if not all(torch.equal(a, b) for a, b in zip(res, results["this"])):
                    raise AssertionError(f"frame {i}: the {k} plain walk differs from this tree's")
            longest.append(int((args[1] - args[0]).max()))
    return {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
            "frames": "test view 0" if view0 else frames, "reps": reps,
            "longest_tile_list": longest,
            **{f"{k}_s": v for k, v in secs.items()}, **{f"{k}_total_s": sum(v) for k, v in secs.items()}}


def main(argv=None) -> None:
    from sgs_tpu_torch.core.device import resolve_device

    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--size", type=int, default=512)
    parser.add_argument("--view0", action="store_true")
    parser.add_argument("--reps", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    a = parser.parse_args(argv)
    print(json.dumps(run(resolve_device(a.device), a.frames, a.size, a.parent, a.view0, a.reps)))


if __name__ == "__main__":
    main()
