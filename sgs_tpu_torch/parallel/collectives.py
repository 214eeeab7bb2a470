"""Differentiable gathers over a process group.

JAX writes the band render inside `shard_map` and gets each collective's
backward from its transpose. Here each is an autograd function:

- `gather_records`: all_gather along dim 0 (every rank's (n, 12) splat
  records into (g n, 12)); its backward is a reduce-scatter that sums the
  records' gradients over the ranks, the transpose of
  `all_gather(tiled=True)` (`sgs_tpu/parallel/tile_shard.py:149`,
  `hybrid.py:158,480`). Each rank's band contributes to every record, so
  the sum is the full gradient.
- `gather_replicated`: the same all_gather, of band images into the full
  image; its backward keeps this rank's own slice and does not sum. Every
  rank of the group computes the same loss on the gathered image, so its
  gradient is the same on every rank, and a sum would multiply it by the
  group size. This is the transpose of the replicating
  `with_sharding_constraint` at `hybrid.py:556`.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def all_gather_tensor(x: torch.Tensor, group) -> torch.Tensor:
    """All ranks' `x` stacked along dim 0, outside autograd."""
    x = x.contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],) + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        # newer torch names these *_single; the card's torch has only these
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x, group=group)
    return out


def _reduce_scatter_sum(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),) + tuple(x.shape[1:]))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM, group=group)
    return out


class _GatherRecords(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_tensor(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _reduce_scatter_sum(grad, ctx.group), None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[0]
        return all_gather_tensor(x, group)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.n:(r + 1) * ctx.n].contiguous(), None


def gather_records(x: torch.Tensor, group) -> torch.Tensor:
    """All ranks' `x` stacked along dim 0; gradients summed back over ranks."""
    return _GatherRecords.apply(x, group)


def gather_replicated(x: torch.Tensor, group) -> torch.Tensor:
    """All ranks' `x` stacked along dim 0, for a loss every rank computes
    alike; each rank's gradient is its own slice of the result's."""
    return _GatherReplicated.apply(x, group)

