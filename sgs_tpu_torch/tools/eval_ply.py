"""Test-split PSNR of a trained PLY snapshot. Port of `scripts/eval_ply.py`.

    python -m sgs_tpu_torch.tools.eval_ply <point_cloud.ply> <dataset_dir> [sh_degree] [--device D]

Loads the snapshot (SH degree 3 unless given) and the dataset's test split
(`eval=True`, unshuffled, the cameras at `-r -1`, as the JAX script's
Scene loads them), renders each test view through the tiled path on a
black background and prints, per view on stderr, its PSNR, and last on
stdout `test_psnr_mean <mean> views <count> gaussians <n>
overflowed_views 0`. The PSNR is the JAX script's: the render clipped to
[0, 1], the mean squared error against the ground truth in numpy f32,
floored at 1e-12, then -10 log10. A missing argument or a non-integer
sh_degree prints the usage and exits 1, as the JAX script does.

Kept out of the port, JAX-only: the count pre-passes over every test view
that size JAX's static buckets, and the exit 2 when a view overflows them:
the port sizes every array from the real counts, so no view overflows and
the count printed is always 0.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.data.camera_utils import camera_list_from_infos
from sgs_tpu_torch.data.scene import read_scene
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.render.pipeline import render
from sgs_tpu_torch.utils.config import ModelParams

USAGE = ("usage: python -m sgs_tpu_torch.tools.eval_ply <point_cloud.ply> "
         "<dataset_dir> [sh_degree] [--device D]")


def view_psnr(image: torch.Tensor, gt: torch.Tensor) -> float:
    """The JAX script's PSNR of one view (module docstring)."""
    img = image.detach().cpu().numpy()
    mse = float(np.mean((np.clip(img, 0, 1) - gt.cpu().numpy()) ** 2))
    return -10.0 * np.log10(max(mse, 1e-12))


def main(argv=None) -> float:
    args = list(sys.argv[1:] if argv is None else argv)
    device = "cuda"
    if "--device" in args:
        i = args.index("--device")
        if i + 1 >= len(args):
            print(USAGE, file=sys.stderr)
            raise SystemExit(1)
        device = args[i + 1]
        del args[i:i + 2]
    if len(args) < 2:
        print(USAGE, file=sys.stderr)
        raise SystemExit(1)
    ply_path, source = args[0], args[1]
    try:
        sh_degree = int(args[2]) if len(args) > 2 else 3
    except ValueError:
        print(f"sh_degree must be an integer\n{USAGE}", file=sys.stderr)
        raise SystemExit(1)
    dev = resolve_device(device)

    model = GaussianModel.from_ply(ply_path, sh_degree, dev)
    n = model.capacity
    print(f"# {n} gaussians from {ply_path}", file=sys.stderr)
    params = ModelParams(source_path=source, sh_degree=sh_degree, eval=True)
    cams = camera_list_from_infos(read_scene(params, dev).test_cameras, 1.0, params.resolution, dev)
    bg = torch.zeros(3, dtype=torch.float32, device=dev)
    inputs = model.render_inputs(sh_degree)
    psnrs = []
    for lc in cams:
        with torch.no_grad():
            image = render(lc.camera, inputs, bg)["render"]
        psnrs.append(view_psnr(image, lc.gt_image))
        print(f"#   view psnr {psnrs[-1]:.2f}", file=sys.stderr)
    mean = float(np.mean(psnrs))
    print(f"test_psnr_mean {mean:.3f} views {len(psnrs)} gaussians {n} overflowed_views 0")
    return mean


if __name__ == "__main__":
    main()
