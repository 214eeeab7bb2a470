"""Train the latent/structured Gaussian model with the PyTorch/CUDA port.

    python -m sgs_tpu_torch.train_lgm -s <scene> [-m <model_dir>] [--eval] [--iterations N]
        [--downsample_init D] [--latent_size L] [--hidden_size H] ...

Flags and defaults are the repository's `train_lgm.py`'s; `--sh_degree` is
forced to 0. Writes cfg_args, input.ply and cameras.json,
point_cloud/iteration_*/point_cloud.ply (the decoded Gaussians) and
chkpnt<iter>.npz (the LGM checkpoint, which the JAX trainer also loads)
in the model directory; --start_checkpoint resumes from one (a JAX
checkpoint loads as it is). `random`, `numpy` and `torch` are seeded with
0, as the JAX CLI seeds `random` and `numpy`, so `--downsample_init`
keeps the same points. Runs on the card; --device cpu runs the plain
PyTorch versions of the kernels instead. --ip, --port, --debug_from,
--detect_anomaly and --debug_latent are accepted and unused, as in JAX
(the network viewer is not ported).
"""

from __future__ import annotations

import os
import random
import sys
import uuid
from argparse import ArgumentParser

import numpy as np
import torch

from sgs_tpu_torch.utils.config import (
    ModelParams,
    OptimizationParams,
    PipelineParams,
    add_dataclass_args,
    extract_dataclass,
)

DEFAULT_ITERS = [1, 100, 500, 1_000, 3_000, 7_000, 30_000, 45_000, 60_000, 75_000, 90_000]


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="LGM training script parameters (PyTorch/CUDA port)")
    add_dataclass_args(parser, ModelParams, "Loading Parameters")
    add_dataclass_args(parser, OptimizationParams, "Optimization Parameters")
    add_dataclass_args(parser, PipelineParams, "Pipeline Parameters")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=DEFAULT_ITERS)
    parser.add_argument("--save_iterations", nargs="+", type=int, default=DEFAULT_ITERS)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--debug_latent", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=DEFAULT_ITERS)
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--latent_size", type=int, default=32)
    parser.add_argument("--hidden_size", type=int, default=32)
    parser.add_argument("--gaussians_per_structure", type=int, default=8)
    parser.add_argument("--use_positional_embedding", action="store_true")
    parser.add_argument("--downsample_init", type=float, default=1.0)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    # a fresh list: argparse hands the shared default list to every parse
    args.save_iterations = list(args.save_iterations) + [args.iterations]

    dataset = extract_dataclass(ModelParams, args)
    dataset.sh_degree = 0
    opt = extract_dataclass(OptimizationParams, args)
    pipe = extract_dataclass(PipelineParams, args)
    if not dataset.model_path:
        dataset.model_path = os.path.join("./output/", str(uuid.uuid4())[0:10])
    print("Optimizing " + dataset.model_path)
    if args.quiet:
        sys.stdout = open(os.devnull, "w")
    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)

    from sgs_tpu_torch.train.lgm_trainer import training_lgm

    training_lgm(
        dataset, opt, pipe, args.test_iterations, args.save_iterations,
        args.checkpoint_iterations, args.start_checkpoint,
        latent_size=args.latent_size, hidden_size=args.hidden_size,
        gaussians_per_structure=args.gaussians_per_structure,
        use_positional_embedding=args.use_positional_embedding,
        downsample_init=args.downsample_init, device=args.device,
    )
    print("\nTraining complete.")


if __name__ == "__main__":
    main(sys.argv[1:])
