"""A resumable checkpoint from a PLY snapshot. Port of
`scripts/make_resume_ckpt.py`.

    python -m sgs_tpu_torch.tools.resume_from_ply <point_cloud.ply> <scene_dir> <iteration>
        <out.npz> [sh_degree=3] [capacity=-1] [--device cpu]

The parameters come from the snapshot (its Gaussians in the first slots,
the rest of the pool dead); Adam's moments are zero and its step counts 0,
the densification statistics are zero; the active SH degree is the
schedule's at `iteration` (one degree every 1000 iterations, up to
`sh_degree`), and spatial_lr_scale is the scene's camera extent, as a
fresh run computes it. capacity -1 takes ceil(1.6 n) rounded up to a
multiple of 4096. The checkpoint is written in the JAX layout
(`train/checkpoint.py`), so either package's trainer resumes from it with
--start_checkpoint. This is how the JAX package's flagship run
(`runs/flagship_r5`) was resumed at 3,000 (`runs/resume3000.npz`).
"""

from __future__ import annotations

import argparse
import sys

import torch

from sgs_tpu_torch.data.ply import load_gaussian_ply
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel
from sgs_tpu_torch.train import checkpoint as ckpt
from sgs_tpu_torch.train.loop import TrainState
from sgs_tpu_torch.train.optim import AdamState


def resume_capacity(n: int) -> int:
    return -(-int(n * 1.6) // 4096) * 4096


def state_from_ply(ply_path: str, sh_degree: int = 3, capacity: int = -1,
                   device: "str | torch.device" = "cpu") -> TrainState:
    """The snapshot's Gaussians in a pool of `capacity` slots, fresh Adam,
    zero statistics."""
    arrays = load_gaussian_ply(ply_path, sh_degree)
    n = arrays["xyz"].shape[0]
    capacity = capacity if capacity > 0 else resume_capacity(n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < n {n}")
    model = GaussianModel.empty(capacity, sh_degree, device)
    for f in PARAM_FIELDS:
        getattr(model, f)[:n] = torch.as_tensor(arrays[f], dtype=torch.float32)
    model.alive[:n] = True
    return TrainState(model=model, adam=AdamState.init(model.params()),
                      stats=DensifyStats.zeros(capacity, model.device))


def scene_extent(scene_dir: str, sh_degree: int = 3, device: "str | torch.device" = "cpu") -> float:
    """The camera extent a fresh run of the scene trains with."""
    from sgs_tpu_torch.data.scene import read_scene
    from sgs_tpu_torch.utils.config import ModelParams

    info = read_scene(ModelParams(source_path=scene_dir, sh_degree=sh_degree, eval=True), device)
    return float(info.nerf_normalization["radius"])


def make_resume_checkpoint(ply_path: str, scene_dir: str, iteration: int, out: str,
                           sh_degree: int = 3, capacity: int = -1,
                           device: "str | torch.device" = "cpu") -> dict:
    """Writes the checkpoint; returns its n, capacity, active SH degree and
    spatial_lr_scale."""
    state = state_from_ply(ply_path, sh_degree, capacity, device)
    extent = scene_extent(scene_dir, sh_degree, device)
    active_sh = min(sh_degree, iteration // 1000)
    ckpt.save_checkpoint(out, state, iteration, active_sh, extent)
    return {"n": int(state.model.alive.sum()), "capacity": state.model.capacity,
            "active_sh_degree": active_sh, "spatial_lr_scale": extent}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("ply")
    p.add_argument("scene")
    p.add_argument("iteration", type=int)
    p.add_argument("out")
    p.add_argument("sh_degree", type=int, nargs="?", default=3)
    p.add_argument("capacity", type=int, nargs="?", default=-1)
    p.add_argument("--device", default="cpu")
    a = p.parse_args(argv)
    info = make_resume_checkpoint(a.ply, a.scene, a.iteration, a.out, a.sh_degree, a.capacity, a.device)
    print(f"# {info['n']} gaussians -> capacity {info['capacity']}; spatial_lr_scale "
          f"{info['spatial_lr_scale']:.4f}; wrote {a.out} at iteration {a.iteration}, "
          f"active_sh {info['active_sh_degree']}", file=sys.stderr)
    return info


if __name__ == "__main__":
    main(sys.argv[1:])
