"""Turntable renders of a trained model. Port of the repository's `view.py`.

    python -m sgs_tpu_torch.view -m <model_dir> [--iteration N] [--frames 24]
        [--radius R] [--height 0.4] [--width 512] [--image_height 512] [-w] [--out orbit/]
        [--no-tight_culling]

The flags and defaults are `view.py`'s. The model's
point_cloud/iteration_<N>/point_cloud.ply (-1: the latest) is loaded at
--sh_degree; the camera orbits the Gaussians' mean at `radius` (0: 2.8x
their largest offset from it) and `height` x that offset, with a 55
degree horizontal field of view (`utils/toy_scene.circle_pose` and
`camera_from_c2w`); each frame renders through the tiled path (binning
and Kernel A on the card; `--no-tight_culling` bins each Gaussian's whole
rect, as `view.py` does, to the same pixels) and is written as `frame_XXX.png`
(`data/png.py`), then all as `orbit.gif` (`data/gif.py`, 120 ms a frame,
looping). Runs on the card; --device cpu runs the plain versions.
"""

from __future__ import annotations

import math
import os
import sys
from argparse import ArgumentParser, BooleanOptionalAction

import numpy as np
import torch


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Turntable viewer (PyTorch/CUDA port)")
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--radius", type=float, default=0.0, help="orbit radius (0 = auto)")
    parser.add_argument("--height", type=float, default=0.4)
    parser.add_argument("--width", type=int, default=512)
    parser.add_argument("--image_height", type=int, default=512)
    parser.add_argument("--white_background", "-w", action="store_true")
    parser.add_argument("--out", type=str, default="")
    parser.add_argument("--tight_culling", default=True, action=BooleanOptionalAction)
    parser.add_argument("--device", default="cuda")
    return parser


def orbit_cameras(center: np.ndarray, spread: float, args, device) -> list:
    """The turntable's cameras, as `view.py` places them."""
    from sgs_tpu_torch.utils.toy_scene import camera_from_c2w, circle_pose

    radius = args.radius or 2.8 * spread
    fovx = math.radians(55)
    cams = []
    for i in range(args.frames):
        theta = 2 * math.pi * i / args.frames
        c2w = circle_pose(theta, radius=radius, height=args.height * spread)
        c2w[:3, 3] += center
        cams.append(camera_from_c2w(c2w, fovx, args.width, args.image_height, device))
    return cams


def main(argv=None) -> None:
    from sgs_tpu_torch.core.device import resolve_device
    from sgs_tpu_torch.data.gif import write_gif
    from sgs_tpu_torch.data.ply import load_gaussian_ply
    from sgs_tpu_torch.data.png import write_png
    from sgs_tpu_torch.data.scene import search_for_max_iteration
    from sgs_tpu_torch.models.gaussians import from_jax_arrays
    from sgs_tpu_torch.render.pipeline import render

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    iteration = args.iteration
    if iteration == -1:
        iteration = search_for_max_iteration(os.path.join(args.model_path, "point_cloud"))
    ply = os.path.join(args.model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")
    print(f"Loading {ply}")
    arrays = load_gaussian_ply(ply, args.sh_degree)
    pool = from_jax_arrays(arrays, args.sh_degree, dev)

    center = arrays["xyz"].mean(axis=0)
    spread = float(np.abs(arrays["xyz"] - center).max())
    out_dir = args.out or os.path.join(args.model_path, "orbit")
    os.makedirs(out_dir, exist_ok=True)
    bg = torch.ones(3, device=dev) if args.white_background else torch.zeros(3, device=dev)

    frames = []
    with torch.no_grad():
        inputs = pool.render_inputs(args.sh_degree)
        for i, cam in enumerate(orbit_cameras(center, spread, args, dev)):
            out = render(cam, inputs, bg, mode="tiled" if args.tight_culling else "rect")
            img = np.clip(out["render"].cpu().numpy().transpose(1, 2, 0), 0, 1)
            frame = (img * 255).astype(np.uint8)
            write_png(os.path.join(out_dir, f"frame_{i:03d}.png"), frame)
            frames.append(frame)
            print(f"frame {i + 1}/{args.frames}")
    write_gif(os.path.join(out_dir, "orbit.gif"), frames, duration_ms=120, loop=0)
    print(f"Wrote {args.frames} frames + orbit.gif to {out_dir}")


if __name__ == "__main__":
    main(sys.argv[1:])
