"""SSIM / PSNR / LPIPS over rendered test sets. Port of the repository's
`metrics.py`.

    python -m sgs_tpu_torch.metrics -m <model_dir> [<model_dir> ...]

Walks <model>/test/<method>/{renders,gt}, writes results.json and
per_view.json. LPIPS (`metrics/lpips.py`) is reported per view and per
method when its weights are found (`lpips_available()`); the repository
carries none, and then LPIPS is null, with the JAX tool's message.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.data.png import read_png
from sgs_tpu_torch.metrics import lpips as lpips_mod
from sgs_tpu_torch.ops.ssim import psnr, ssim


def read_image(path: Path, device: torch.device) -> torch.Tensor:
    arr = read_png(str(path)).astype(np.float32) / 255.0
    return torch.from_numpy(np.ascontiguousarray(arr[:, :, :3].transpose(2, 0, 1))).to(device)


def evaluate(model_paths, device: "str | torch.device" = "cuda") -> dict:
    """Returns {scene: {method: {SSIM, PSNR, LPIPS}}} and writes the JSONs."""
    dev = resolve_device(device)
    use_lpips = lpips_mod.lpips_available()
    if not use_lpips:
        print("[metrics] LPIPS weights not found — reporting LPIPS as null")
    full = {}
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full[scene_dir], per_view = {}, {}
        test_dir = Path(scene_dir) / "test"
        if not test_dir.is_dir():
            print(f"  no test dir in {scene_dir}")
            continue
        for method in sorted(os.listdir(test_dir)):
            print("Method:", method)
            method_dir = test_dir / method
            names = sorted(os.listdir(method_dir / "renders"))
            ssims, psnrs, lpipss = [], [], []
            for name in names:
                r = read_image(method_dir / "renders" / name, dev)
                g = read_image(method_dir / "gt" / name, dev)
                ssims.append(float(ssim(r, g)))
                psnrs.append(float(psnr(r, g)))
                if use_lpips:
                    lpipss.append(float(lpips_mod.lpips(r, g, net_type="vgg")[0]))
            print(f"  SSIM : {np.mean(ssims):>12.7f}")
            print(f"  PSNR : {np.mean(psnrs):>12.7f}")
            if use_lpips:
                print(f"  LPIPS: {np.mean(lpipss):>12.7f}")
            full[scene_dir][method] = {
                "SSIM": float(np.mean(ssims)),
                "PSNR": float(np.mean(psnrs)),
                "LPIPS": float(np.mean(lpipss)) if use_lpips else None,
            }
            per_view[method] = {
                "SSIM": dict(zip(names, ssims)),
                "PSNR": dict(zip(names, psnrs)),
                "LPIPS": dict(zip(names, lpipss)) if use_lpips else {},
            }
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full[scene_dir], f, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view, f, indent=True)
    return full


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Metrics of rendered test sets (PyTorch/CUDA port)")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    evaluate(args.model_paths, args.device)
