"""Render the train/test views of a trained model to PNGs on the card.
Port of the repository's `render.py`, for every scene the port's `Scene`
reads (Blender, COLMAP, Zero123) at every `-r/--resolution`.

    python -m sgs_tpu_torch.render -m <model_dir> [-s <scene>] [--iteration N]
        [--skip_train] [--skip_test] [--quiet] [--eval | --no-eval] [--ply <file>]

The flags are `render.py`'s: the model flags (registered with sentinel
defaults and merged over <model>/cfg_args, so `-m` alone recovers the
scene, `eval` and the background), the pipeline flags, --iteration,
--skip_train, --skip_test and --quiet. The views come from the port's
`Scene` with `shuffle=False`, so with `eval` False the test views are
rendered as part of train and no test set is written. Writes
<model>/{train,test}/ours_<iteration>/{renders,gt}/%05d.png. Two flags are
the port's own: --ply renders that file in place of the model
directory's snapshot (--iteration then only names the output), and
--device cpu runs the plain PyTorch versions of the kernels.
`--rasterizer reference` renders with the O(N*P) oracle in place of
binning and Kernel A.
"""

from __future__ import annotations

import contextlib
import os
from argparse import ArgumentParser
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.data.png import write_png
from sgs_tpu_torch.data.camera_utils import LoadedCamera
from sgs_tpu_torch.data.scene import Scene
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.train.loop import eval_render
from sgs_tpu_torch.utils.config import (
    ModelParams,
    PipelineParams,
    add_dataclass_args,
    check_rasterizer,
    extract_dataclass,
    get_combined_args,
)


def quantize(image_chw: torch.Tensor) -> np.ndarray:
    """(C, H, W) float -> (H, W, C) uint8 as the JAX render.py quantises:
    clip, *255 + 0.5, truncate."""
    arr = np.clip(image_chw.detach().cpu().numpy(), 0.0, 1.0)
    return (arr.transpose(1, 2, 0) * 255 + 0.5).astype(np.uint8)


def save_png(path: str, image_chw: torch.Tensor) -> None:
    write_png(path, quantize(image_chw))


def render_set(out_dir: Path, views: List[LoadedCamera], model: GaussianModel,
               sh_degree: int, background: torch.Tensor, mode: str = "tiled") -> None:
    renders, gts = out_dir / "renders", out_dir / "gt"
    renders.mkdir(parents=True, exist_ok=True)
    gts.mkdir(parents=True, exist_ok=True)
    for idx, view in enumerate(views):
        image = eval_render(model, view.camera, background, sh_degree, mode)
        save_png(str(renders / f"{idx:05d}.png"), image)
        save_png(str(gts / f"{idx:05d}.png"), view.gt_image)


def render_sets(dataset: ModelParams, iteration: int, pipe: PipelineParams, skip_train: bool,
                skip_test: bool, ply: Optional[str] = None,
                device: "str | torch.device" = "cuda") -> int:
    """Render a model's splits, as `render.py::render_sets`; returns the
    iteration it labelled them with."""
    check_rasterizer(pipe)
    if not dataset.source_path:
        raise ValueError("no scene: pass -s or keep cfg_args in the model dir")
    dev = resolve_device(device)
    scene = Scene(dataset, load_iteration=iteration, shuffle=False, device=dev, ply_path=ply)
    background = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                              device=dev)
    for split, views, skip in (("train", scene.train_cameras, skip_train),
                               ("test", scene.test_cameras, skip_test)):
        if not skip:
            render_set(Path(dataset.model_path) / split / f"ours_{scene.loaded_iter}", views,
                       scene.pool, dataset.sh_degree, background, pipe.rasterizer)
    return scene.loaded_iter


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Testing script parameters (PyTorch/CUDA port)")
    add_dataclass_args(parser, ModelParams, "Loading Parameters", sentinel=True)
    add_dataclass_args(parser, PipelineParams, "Pipeline Parameters")
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--ply", default=None, help="render this PLY instead of the model dir's")
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> None:
    args = get_combined_args(build_parser(), argv)
    if not args.model_path:
        raise SystemExit("render: -m/--model_path is required")
    print("Rendering " + args.model_path)
    with open(os.devnull, "w") as null, contextlib.ExitStack() as stack:
        if args.quiet:
            stack.enter_context(contextlib.redirect_stdout(null))
        render_sets(extract_dataclass(ModelParams, args), args.iteration,
                    extract_dataclass(PipelineParams, args), args.skip_train, args.skip_test,
                    getattr(args, "ply", None), args.device)
