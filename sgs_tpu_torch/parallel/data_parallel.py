"""Camera-batch data parallelism. Port of `sgs_tpu/parallel/data_parallel.py`.

Every rank holds the whole pool (`replicate_state`: a broadcast from the
group's first rank) and trains its own slice of the step's camera batch
(`shard_camera_batch`) with the single-view loss and backward of
`train/loop.py` (`view_grads`, Kernels A-D). The parameter gradients, the
loss and the L1 are means over the batch: the rank's local mean, summed
over the group, divided by its size (`group_means`). The densification
statistics are summed over ranks, the radii maxed (`reduce_stats`). The
non-finite count is taken once, on the reduced parameter gradients, and
the screen-space tap is not guarded, as in the JAX step
(`data_parallel.py:140-145`). Then `train/loop.py::apply_grads` (masked
Adam) runs on every rank alike. The hybrid step reduces with the same two
functions.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel
from sgs_tpu_torch.parallel.mesh import axis
from sgs_tpu_torch.render.pipeline import render
from sgs_tpu_torch.train.loop import TrainState, apply_grads, view_grads, zero_nonfinite

_CAMERA_LEAVES = ("world_view_transform", "full_proj_transform", "camera_center", "tanfovx", "tanfovy")


def stack_cameras(cams: List[Camera]) -> Camera:
    """Equal-resolution cameras as one Camera whose tensors lead with the batch."""
    w, h = cams[0].image_width, cams[0].image_height
    assert all(c.image_width == w and c.image_height == h for c in cams)
    return Camera(**{k: torch.stack([getattr(c, k) for c in cams]) for k in _CAMERA_LEAVES},
                  image_width=w, image_height=h)


def camera_at(cam_batch: Camera, i: int) -> Camera:
    """Camera i of a stacked batch."""
    return Camera(**{k: getattr(cam_batch, k)[i] for k in _CAMERA_LEAVES},
                  image_width=cam_batch.image_width, image_height=cam_batch.image_height)


def shard_camera_batch(cam_batch: Camera, gt_batch: torch.Tensor, mesh):
    """This rank's contiguous slice of a stacked camera batch and its GTs
    over the "data" axis (the batch must divide by the axis size)."""
    _, r, n = axis(mesh, "data")
    b = gt_batch.shape[0]
    if b % n:
        raise ValueError(f"a batch of {b} cameras does not split over {n} ranks")
    lo, hi = r * b // n, (r + 1) * b // n
    cams = Camera(**{k: getattr(cam_batch, k)[lo:hi] for k in _CAMERA_LEAVES},
                  image_width=cam_batch.image_width, image_height=cam_batch.image_height)
    return cams, gt_batch[lo:hi]


def replicate_state(state: TrainState, mesh) -> TrainState:
    """Every tensor of the state broadcast, in place, from the "data" axis's
    first rank, so all ranks start a step from the same bits."""
    group, _, _ = axis(mesh, "data")
    src = dist.get_global_rank(group, 0)
    m, s = state.model, state.stats
    tensors = [getattr(m, f) for f in PARAM_FIELDS] + [*state.adam.mu.values(), *state.adam.nu.values(),
                                                       s.xyz_gradient_accum, s.denom, s.max_radii2d]
    for t in tensors:
        dist.broadcast(t, src=src, group=group)
    alive = m.alive.to(torch.uint8)
    dist.broadcast(alive, src=src, group=group)
    m.alive.copy_(alive.to(torch.bool))
    return state


def flatten_grads(param_grads: Dict[str, torch.Tensor], loss: torch.Tensor,
                  l1: torch.Tensor) -> torch.Tensor:
    """One view's parameter gradients, loss and L1 as one flat vector."""
    return torch.cat([param_grads[f].reshape(-1) for f in PARAM_FIELDS] + [loss.reshape(1), l1.reshape(1)])


def group_means(sums: torch.Tensor, n_views: int, group, n_ranks: int, model: GaussianModel):
    """The batch means from each rank's `flatten_grads` summed over its
    `n_views` views: the local mean, summed over the group, divided by its
    size. Returns (parameter gradients, loss, l1)."""
    means = sums / torch.full_like(sums, float(n_views))
    dist.all_reduce(means, group=group)
    means = means / torch.full_like(means, float(n_ranks))
    param_grads, pos = {}, 0
    for f in PARAM_FIELDS:
        x = getattr(model, f)
        param_grads[f] = means[pos:pos + x.numel()].reshape(x.shape)
        pos += x.numel()
    return param_grads, means[pos], means[pos + 1]


def reduce_stats(stats: DensifyStats, group) -> DensifyStats:
    """One rank's densification statistics summed over the group, the
    radii maxed."""
    n = stats.denom.shape[0]
    sums = torch.cat([stats.xyz_gradient_accum, stats.denom])
    dist.all_reduce(sums, group=group)
    maxrad = stats.max_radii2d.clone()
    dist.all_reduce(maxrad, op=dist.ReduceOp.MAX, group=group)
    return DensifyStats(xyz_gradient_accum=sums[:n], denom=sums[n:], max_radii2d=maxrad)


def make_dp_train_step(mesh, active_sh_degree: int, lambda_dssim: float = 0.2,
                       freeze_xyz: bool = False, mode: str = "tiled", apply_update: bool = True):
    """The data-parallel training step.

    Call: step(state (replicated), cam_batch (this rank's stacked cameras,
    `shard_camera_batch`), gt_batch (Bl, 3, H, W), bg, lrs) -> (state,
    metrics): loss, l1, overflow (0) and nonfinite_grads."""
    group, _, n_ranks = axis(mesh, "data")

    def step(state: TrainState, cam_batch: Camera, gt_batch: torch.Tensor, bg: torch.Tensor,
             lrs: Dict[str, float]):
        model = state.model
        bl = gt_batch.shape[0]
        sums, local = None, DensifyStats.zeros(model.capacity, model.device)
        for i in range(bl):
            camera = camera_at(cam_batch, i)

            def render_fn(leaves, tap):
                return render(camera, model.with_params(leaves).render_inputs(active_sh_degree), bg,
                              vspace_tap=tap, mode=mode)

            loss, ll1, param_grads, tap_grad, out = view_grads(model, render_fn, gt_batch[i], lambda_dssim)
            with torch.no_grad():
                flat = flatten_grads(param_grads, loss, ll1)
                sums = flat if sums is None else sums + flat
                local = local.update(tap_grad, out["radii"], out["visibility_filter"])

        with torch.no_grad():
            param_grads, loss_mean, l1_mean = group_means(sums, bl, group, n_ranks, model)
            nonfinite, grads = zero_nonfinite([param_grads[f] for f in PARAM_FIELDS])
            new_state = apply_grads(state, dict(zip(PARAM_FIELDS, grads)),
                                    state.stats.merge(reduce_stats(local, group)), lrs, freeze_xyz,
                                    apply_update)
        metrics = {"loss": loss_mean, "l1": l1_mean, "overflow": 0, "nonfinite_grads": nonfinite}
        return new_state, metrics

    return step
