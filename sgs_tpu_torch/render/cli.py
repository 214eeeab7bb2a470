"""Render the train/test views of a trained model to PNGs on the card.
Port of the repository's `render.py` for NeRF-synthetic scenes.

    python -m sgs_tpu_torch.render -m <model_dir> [-s <scene>] [--ply <file>]

Writes <model>/{train,test}/ours_<iteration>/{renders,gt}/%05d.png. The
scene, background and SH degree come from <model>/cfg_args unless given.
With --ply the model is that file and --iteration only names the output.
"""

from __future__ import annotations

import argparse
import ast
import os
import re
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.data.png import write_png
from sgs_tpu_torch.data.readers import LoadedCamera, read_nerf_synthetic_split
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.train.loop import eval_render


def read_cfg_args(model_path: str) -> dict:
    """The `Namespace(...)` that training wrote to <model>/cfg_args, as a dict."""
    path = os.path.join(model_path, "cfg_args")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        node = ast.parse(f.read().strip(), mode="eval").body
    if not isinstance(node, ast.Call):
        raise ValueError(f"{path}: expected Namespace(...)")
    return {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}


def latest_iteration(model_path: str) -> int:
    its = [
        int(m.group(1))
        for d in os.listdir(os.path.join(model_path, "point_cloud"))
        if (m := re.fullmatch(r"iteration_(\d+)", d))
    ]
    if not its:
        raise FileNotFoundError(f"no point_cloud/iteration_* in {model_path}")
    return max(its)


def save_png(path: str, image_chw: torch.Tensor) -> None:
    """Quantise as the JAX render.py does: clip, *255 + 0.5, truncate."""
    arr = np.clip(image_chw.detach().cpu().numpy(), 0.0, 1.0)
    write_png(path, (arr.transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8))


def render_set(out_dir: Path, views: List[LoadedCamera], model: GaussianModel,
               sh_degree: int, background: torch.Tensor) -> None:
    renders, gts = out_dir / "renders", out_dir / "gt"
    renders.mkdir(parents=True, exist_ok=True)
    gts.mkdir(parents=True, exist_ok=True)
    for idx, view in enumerate(views):
        image = eval_render(model, view.camera, background, sh_degree)
        save_png(str(renders / f"{idx:05d}.png"), image)
        save_png(str(gts / f"{idx:05d}.png"), view.gt_image)


def render_sets(model_path: str, source_path: Optional[str] = None, ply: Optional[str] = None,
                iteration: int = -1, white_background: Optional[bool] = None,
                sh_degree: Optional[int] = None, skip_train: bool = False, skip_test: bool = False,
                device: "str | torch.device" = "cuda") -> int:
    """Render a model's splits; returns the iteration it labelled them with."""
    dev = resolve_device(device)
    cfg = read_cfg_args(model_path)
    source_path = source_path or cfg.get("source_path")
    if not source_path:
        raise ValueError("no scene: pass -s or keep cfg_args in the model dir")
    white = cfg.get("white_background", False) if white_background is None else white_background
    sh_degree = cfg.get("sh_degree", 3) if sh_degree is None else sh_degree
    resolution = cfg.get("resolution", -1)
    if ply is None:
        iteration = latest_iteration(model_path) if iteration == -1 else iteration
        ply = os.path.join(model_path, "point_cloud", f"iteration_{iteration}", "point_cloud.ply")
    model = GaussianModel.from_ply(ply, sh_degree, dev)
    background = torch.tensor([1.0, 1.0, 1.0] if white else [0.0, 0.0, 0.0], device=dev)
    splits = [s for s, skip in (("train", skip_train), ("test", skip_test)) if not skip]
    for split in splits:
        if not os.path.exists(os.path.join(source_path, f"transforms_{split}.json")):
            continue
        views = read_nerf_synthetic_split(source_path, split, white, resolution, dev)
        render_set(Path(model_path) / split / f"ours_{iteration}", views, model, sh_degree, background)
    return iteration


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Render a trained model's views (PyTorch/CUDA port)")
    parser.add_argument("--model_path", "-m", required=True)
    parser.add_argument("--source_path", "-s", default=None)
    parser.add_argument("--ply", default=None, help="render this PLY instead of the model dir's")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--white_background", "-w", action="store_true", default=None)
    parser.add_argument("--sh_degree", type=int, default=None)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    print("Rendering " + args.model_path)
    render_sets(
        args.model_path, args.source_path, args.ply, args.iteration, args.white_background,
        args.sh_degree, args.skip_train, args.skip_test, args.device,
    )
