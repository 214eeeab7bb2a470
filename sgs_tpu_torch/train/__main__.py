"""Train a 3D Gaussian Splatting model with the PyTorch/CUDA port.

    python -m sgs_tpu_torch.train -s <scene> [-m <model_dir>] [--eval] [--iterations N] ...

Flags, defaults and outputs are the repository's `train.py`'s: cfg_args
and opt_args, losses.tsv, point_cloud/iteration_*/point_cloud.ply and
chkpnt<iter>.npz in the model directory. --debug_from is accepted and
unused, as in JAX; --detect_anomaly turns on
`torch.autograd.set_detect_anomaly` (JAX: `jax_debug_nans`);
--profile_dir writes a `torch.profiler` Chrome trace of the whole
`training(...)` call to <profile_dir>/trace.json (JAX: a `jax.profiler`
trace over the same window). `--rasterizer reference` trains through
the O(N*P) oracle, its backward by autograd; `--no-tight_culling` bins
each Gaussian's whole rect (JAX's rect binning). Runs on the card; --device
cpu runs the plain PyTorch versions of the kernels instead.
`utils/general.safe_state` stamps every printed line (--quiet silences
them) and seeds `random`, `numpy` and `torch` with 0; stdout is put back
when the call returns. The trainer serves the network viewer once per
iteration, but this CLI starts no listener, as `train.py` starts none
(--ip/--port are accepted and unused). --seed (the port's own, 0 by
default as in JAX) seeds the trainer's camera order and its generator
(split noise, random backgrounds). Not ported: tensorboard.

Multi-device training runs one process a rank under torchrun, which sets
the rank, world size and rendezvous:

    torchrun --nproc_per_node=N -m sgs_tpu_torch.train -s <scene> -m <out> --parallel dp
    torchrun --nproc_per_node=N -m sgs_tpu_torch.train -s <scene> -m <out> --parallel hybrid \
        [--parallel_mesh DxG] [--hy_balance]

(NCCL on the card, one card a rank; with --device cpu, gloo). Rank 0
writes the outputs and prints; the other ranks run as with --quiet. Give
-m: without it each rank would name its own output directory.
"""

from __future__ import annotations

import os
import sys
import uuid
from argparse import ArgumentParser, Namespace

import torch
import torch.distributed as dist

from sgs_tpu_torch.utils.config import (
    ModelParams,
    OptimizationParams,
    PipelineParams,
    add_dataclass_args,
    extract_dataclass,
)
from sgs_tpu_torch.utils.general import stamped


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Training script parameters (PyTorch/CUDA port)")
    add_dataclass_args(parser, ModelParams, "Loading Parameters")
    add_dataclass_args(parser, OptimizationParams, "Optimization Parameters")
    add_dataclass_args(parser, PipelineParams, "Pipeline Parameters")
    save_iters = [1_000, 7_000, 15_000, 30_000]
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--debug_from", type=int, default=-1)
    parser.add_argument("--detect_anomaly", action="store_true", default=False)
    parser.add_argument("--test_iterations", nargs="+", type=int, default=save_iters)
    parser.add_argument("--save_iterations", nargs="+", type=int, default=save_iters)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=save_iters)
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="write a torch.profiler trace of the training run to this directory")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the camera order and of densify's and the backgrounds' draws")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.save_iterations.append(args.iterations)

    dataset = extract_dataclass(ModelParams, args)
    opt = extract_dataclass(OptimizationParams, args)
    pipe = extract_dataclass(PipelineParams, args)
    if not dataset.model_path:
        dataset.model_path = os.path.join("./output/", str(uuid.uuid4())[0:10])
    rank0 = int(os.environ.get("RANK", "0")) == 0
    if rank0:
        print("Optimizing " + dataset.model_path)
        os.makedirs(dataset.model_path, exist_ok=True)
        with open(os.path.join(dataset.model_path, "opt_args"), "w") as f:
            f.write(str(Namespace(**{k: v for k, v in vars(opt).items() if not k.startswith("_")})))
    with stamped(args.quiet or not rank0):
        if args.detect_anomaly:
            torch.autograd.set_detect_anomaly(True)

        from sgs_tpu_torch.train.trainer import training

        def run() -> None:
            training(dataset, opt, pipe, args.test_iterations, args.save_iterations,
                     args.checkpoint_iterations, args.start_checkpoint, seed=args.seed,
                     device=args.device)

        owns_group = not dist.is_initialized()
        if args.profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if torch.device(args.device).type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                run()
            os.makedirs(args.profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))
        else:
            run()
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
        print("\nTraining complete.")


if __name__ == "__main__":
    main(sys.argv[1:])
