"""Evaluate a checkpoint's L1 and PSNR over every train and test camera.
Port of the repository's `get_psnr.py`.

    python -m sgs_tpu_torch.get_psnr -s <scene> [-m <out_dir>] --start_checkpoint <file>
        [--eval] [--sh_degree N] [--quiet] ...

The flags are `get_psnr.py`'s (the model, optimisation and pipeline flags,
--start_checkpoint, required, and --quiet). The checkpoint is a training
checkpoint in the JAX npz layout (`train/checkpoint.py`), or a raw
vectorized (N, 11 + 3K) float array in a `.npy` (shape columns, then
appearance columns; `models/vectorized.py::from_vector`). One
`training_report` over the test views and every train view writes
<out_dir>/losses.tsv (default ./output/get_psnr) and prints both lines.
The views are rendered with `training_report`'s default mode, the
reference rasterizer (the O(N*P) oracle), whatever --rasterizer says:
get_psnr.py passes no mode, so JAX renders its numbers with the oracle.
--device cpu (the port's own flag) runs on the CPU.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.utils.config import (
    ModelParams,
    OptimizationParams,
    PipelineParams,
    add_dataclass_args,
    extract_dataclass,
)
from sgs_tpu_torch.utils.general import stamped


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="get_psnr parameters (PyTorch/CUDA port)")
    add_dataclass_args(parser, ModelParams, "Loading Parameters")
    add_dataclass_args(parser, OptimizationParams, "Optimization Parameters")
    add_dataclass_args(parser, PipelineParams, "Pipeline Parameters")
    parser.add_argument("--start_checkpoint", type=str, required=True)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dataset = extract_dataclass(ModelParams, args)
    if not dataset.model_path:
        dataset.model_path = os.path.join("./output/", "get_psnr")
    with stamped(args.quiet):
        evaluate(dataset, args.start_checkpoint, args.device)


def evaluate(dataset: ModelParams, checkpoint: str, device: "str | torch.device" = "cuda") -> None:
    from sgs_tpu_torch.data.scene import Scene
    from sgs_tpu_torch.train.trainer import training_report

    dev = resolve_device(device)
    scene = Scene(dataset, device=dev)
    active_sh_degree = dataset.sh_degree
    if checkpoint.endswith(".npz"):
        from sgs_tpu_torch.train.checkpoint import load_checkpoint

        state, iteration, active_sh_degree, _ = load_checkpoint(checkpoint, dev)
        model = state.model
    else:
        # a raw vectorized array: (N, 11 + 3K), shape | appearance
        from sgs_tpu_torch.models.vectorized import from_vector

        vec = np.load(checkpoint)
        model = from_vector(dataset.sh_degree, vec[:, :11], vec[:, 11:], device=dev)
        iteration = 0
    bg = torch.tensor([1.0, 1.0, 1.0] if dataset.white_background else [0.0, 0.0, 0.0],
                      dtype=torch.float32, device=dev)
    os.makedirs(dataset.model_path, exist_ok=True)
    with open(os.path.join(dataset.model_path, "losses.tsv"), "w") as tsv:
        tsv.write("iteration\ttest_l1\ttest_psnr\tnum_gaussians\n")
        # every train view, as the reference's get_psnr.py evaluates them
        training_report(tsv, iteration, scene, model, active_sh_degree, bg, full_train_set=True)
    print("Done.")


if __name__ == "__main__":
    main(sys.argv[1:])
