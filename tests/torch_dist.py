"""Run a function on N gloo ranks in fresh processes, for the port's
multi-device tests on the CPU.

`spawn(fn, world, *args)` starts `world` processes (`torch.multiprocessing`,
start method "spawn") with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT), so the rank body
joins the group through `sgs_tpu_torch.parallel.mesh.init_distributed("cpu")`
as a torchrun process would. Each rank's return value is pickled and the
list comes back in rank order. `fn` must be a module-level function of a
module that imports no JAX: the children import only torch and the port.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sgs_tpu_torch.parallel.mesh import free_port


def _entry(rank, fn, world, port, out_dir, args, local_world):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank % local_world),
                      LOCAL_WORLD_SIZE=str(local_world), MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    result = fn(rank, world, *args)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, world: int, *args, local_world: int = 0) -> list:
    """`local_world` ranks a host (default: all on one), as torchrun's
    LOCAL_WORLD_SIZE on several hosts would say."""
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_entry, args=(fn, world, free_port(), out_dir, args, local_world or world),
                 nprocs=world, join=True)
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def state_from_arrays(a: dict, device: str = "cpu"):
    """A port TrainState from numpy arrays: the six fields and `alive`,
    `mu_<f>`, `nu_<f>`, `step` (one count for every field) and the three
    statistics."""
    from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel
    from sgs_tpu_torch.train.loop import TrainState
    from sgs_tpu_torch.train.optim import AdamState

    def t(x):
        return torch.as_tensor(x.copy(), device=device)

    model = GaussianModel(**{f: t(a[f]) for f in PARAM_FIELDS}, alive=t(a["alive"]),
                          max_sh_degree=int(a["max_sh_degree"]))
    adam = AdamState(mu={f: t(a[f"mu_{f}"]) for f in PARAM_FIELDS},
                     nu={f: t(a[f"nu_{f}"]) for f in PARAM_FIELDS},
                     step={f: int(a["step"]) for f in PARAM_FIELDS})
    stats = DensifyStats(xyz_gradient_accum=t(a["xyz_gradient_accum"]), denom=t(a["denom"]),
                         max_radii2d=t(a["max_radii2d"]))
    return TrainState(model=model, adam=adam, stats=stats)


def state_arrays(state) -> dict:
    """The inverse of `state_from_arrays` (the Adam step is dropped)."""
    from sgs_tpu_torch.models.gaussians import PARAM_FIELDS

    m, s = state.model, state.stats
    out = {f: getattr(m, f).detach().cpu().numpy() for f in PARAM_FIELDS}
    out["alive"] = m.alive.cpu().numpy()
    for f in PARAM_FIELDS:
        out[f"mu_{f}"] = state.adam.mu[f].cpu().numpy()
        out[f"nu_{f}"] = state.adam.nu[f].cpu().numpy()
    out.update(xyz_gradient_accum=s.xyz_gradient_accum.cpu().numpy(), denom=s.denom.cpu().numpy(),
               max_radii2d=s.max_radii2d.cpu().numpy())
    return out


def cameras(specs, device: str = "cpu") -> list:
    """Port cameras from (R, T, fovx, fovy, width, height) tuples."""
    from sgs_tpu_torch.core.camera import Camera

    return [Camera.from_Rt(*s, device=device) for s in specs]


def train_e2e(rank, world, scene_dir, model_dir, mode, mesh_str="", balance=False):
    """The rank body of the end-to-end mirrors of JAX's slow multi-chip
    runs (`tests/test_parallel.py:120,214,254,301`): 40 iterations from
    1,000 random points (the scene's 100,000 cut by 100), densify every 10
    from 9, opacity reset at 30, reports at 1 and 40, a checkpoint at 40.
    Returns rank 0's losses.tsv rows, every rank's count of Gaussians and
    whether its xyz is finite."""
    import random

    import numpy as np

    from sgs_tpu_torch.data.scene import Scene
    from sgs_tpu_torch.train.trainer import training
    from sgs_tpu_torch.utils.config import ModelParams, OptimizationParams, PipelineParams

    random.seed(0)
    np.random.seed(0)
    torch.manual_seed(0)
    data = ModelParams(source_path=scene_dir, model_path=model_dir, white_background=True, eval=True)
    opt = OptimizationParams(iterations=40, densify_from_iter=9, densification_interval=10,
                             densify_until_iter=35, opacity_reset_interval=30, position_lr_max_steps=40)
    pipe = PipelineParams(no_tqdm=True, parallel=mode, parallel_mesh=mesh_str, hy_balance=balance)
    scene = Scene(data, device="cpu", downsample_init=100.0)
    state = training(data, opt, pipe, [1, 40], [], [40], scene=scene, device="cpu")
    rows = None
    if rank == 0:
        with open(os.path.join(model_dir, "losses.tsv")) as f:
            rows = [r.split("\t") for r in f.read().strip().splitlines()[1:]]
    return {"rows": rows, "alive": state.model.num_alive,
            "finite": bool(torch.isfinite(state.model.xyz).all())}
