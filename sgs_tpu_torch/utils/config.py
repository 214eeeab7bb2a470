"""Typed training configuration. Port of `sgs_tpu/utils/config.py`.

Field names, defaults and one-letter shorthands match the JAX package's
flag for flag, so a JAX command line and its cfg_args carry across. The
pipeline flags that select JAX rasterizers or multi-chip modes are kept
by name; the port's trainer and render CLI raise on the values they do
not run. Render-time tools register the model flags with sentinel None
defaults and merge them over the persisted cfg_args (`get_combined_args`).
"""

from __future__ import annotations

import ast
import os
from argparse import ArgumentParser, BooleanOptionalAction, Namespace
from dataclasses import dataclass, field, fields


@dataclass
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""  # shorthand -s
    model_path: str = ""  # shorthand -m
    images: str = "images"  # shorthand -i
    resolution: int = -1  # shorthand -r
    white_background: bool = False  # shorthand -w
    decimate_factor: float = 1.0
    mesh_max_faces: int = 16_000
    obj_path: str = ""
    data_device: str = "cuda"  # accepted for CLI compatibility; the trainer's device decides
    eval: bool = True
    freeze_xyz: bool = False

    _shorthands = {
        "source_path": "-s",
        "model_path": "-m",
        "images": "-i",
        "resolution": "-r",
        "white_background": "-w",
    }


@dataclass
class PipelineParams:
    # accepted no-ops, as in the JAX package
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    no_tqdm: bool = False
    debug: bool = False
    # kept by name for command-line compatibility: the port runs the tiled
    # rasterizer with tight culling on a single device only
    rasterizer: str = "tiled"
    raster_backend: str = "auto"
    parallel: str = "none"
    parallel_mesh: str = ""
    hy_balance: bool = False
    hy_compact: bool = True
    tight_culling: bool = True

    _shorthands: dict = field(default_factory=dict)


@dataclass
class OptimizationParams:
    iterations: int = 90_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False

    _shorthands: dict = field(default_factory=dict)


def add_dataclass_args(parser: ArgumentParser, cls, group_name: str, sentinel: bool = False) -> None:
    """One flag per field (with its shorthand); bools as --flag/--no-flag.

    sentinel=True makes every default None, so a value persisted in
    cfg_args survives `get_combined_args` unless the flag is given; with
    --flag/--no-flag a True persisted there can still be turned off."""
    group = parser.add_argument_group(group_name)
    shorthands = getattr(cls, "_shorthands", {}) or {}
    if not isinstance(shorthands, dict):
        shorthands = {}
    for f in fields(cls):
        if f.name.startswith("_"):
            continue
        names = ["--" + f.name] + ([shorthands[f.name]] if f.name in shorthands else [])
        default = None if sentinel else f.default
        if f.type in (bool, "bool"):
            group.add_argument(*names, default=default, action=BooleanOptionalAction)
        else:
            t = {"int": int, "float": float, "str": str}.get(f.type, str)
            group.add_argument(*names, default=default, type=t)


def extract_dataclass(cls, args: Namespace):
    """The dataclass of the parsed flags; a None value keeps the default."""
    kwargs = {
        f.name: getattr(args, f.name)
        for f in fields(cls)
        if not f.name.startswith("_") and getattr(args, f.name, None) is not None
    }
    obj = cls(**kwargs)
    if isinstance(obj, ModelParams) and obj.source_path:
        obj.source_path = os.path.abspath(obj.source_path)
    return obj


def save_cfg_args(model_path: str, model_params: ModelParams) -> None:
    """Write the Namespace literal of the model flags to <model>/cfg_args,
    which the render tool reads back."""
    os.makedirs(model_path, exist_ok=True)
    ns = Namespace(**{
        f.name: getattr(model_params, f.name) for f in fields(ModelParams)
        if not f.name.startswith("_")
    })
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(ns))


def read_cfg_args(model_path: str) -> dict:
    """The `Namespace(...)` literal in <model>/cfg_args as a dict, read
    without eval; {} if the file is missing."""
    path = os.path.join(model_path, "cfg_args")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        node = ast.parse(f.read().strip(), mode="eval").body
    if not isinstance(node, ast.Call):
        raise ValueError(f"{path}: expected Namespace(...)")
    return {kw.arg: ast.literal_eval(kw.value) for kw in node.keywords}


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """The command line over the model directory's persisted cfg_args:
    every flag given (not None) wins, the rest come from cfg_args."""
    args_cmdline = parser.parse_args(argv)
    merged = read_cfg_args(args_cmdline.model_path) if args_cmdline.model_path else {}
    merged.update({k: v for k, v in vars(args_cmdline).items() if v is not None})
    return Namespace(**merged)


def check_rasterizer(pipe: PipelineParams) -> None:
    """The port renders with the tiled rasterizer and tight culling only."""
    if pipe.rasterizer != "tiled" or not pipe.tight_culling:
        raise NotImplementedError("the port renders with the tiled rasterizer and tight culling only")
