"""The arithmetic of the JAX package's per-Gaussian gradient reduction on its
production path, for measuring what it does to training. On no path of the
port.

The JAX trainer's tiled rasterizer with tight culling sums each Gaussian's
instance gradients with `sgs_tpu/ops/pallas/flat_raster.py::
reduce_grads_presort`: the (M, 9) instance records, in presort order
(depth rank major, so every Gaussian's instances are contiguous) and
zero-padded to the instance bucket M, go through two f32 cumulative sums
(lanes mx, my, ca, cb, cc, op, r, g, then b), each lane-packed 16 records
to a 128-lane row and summed in groups of 256 rows plus a running offset
across groups; each Gaussian's sum is then the difference of the prefix at
the end of its run and at its start. Kernel C (`ops/flat_raster.py::
reduce_runs`) sums each run on its own.

A prefix difference carries the rounding of the prefix, about the f32 ulp
of the sum of every gradient before the run, whatever the run's own size.
On the flagship's real states that error is larger than a tenth of the
true sum for most Gaussians' conic gradients (`tests/f5_probe.py
reduction`), and one non-finite instance gradient makes every later
prefix, and so every later Gaussian's sum, non-finite: JAX's guard then
zeroes about 13 elements of nearly every slot of the pool.

`jax_prefix_reduce(inst, rank_start, order)` computes that arithmetic with
PyTorch operations on the inputs `reduce_runs` takes, so that
`tools/flagship_long_run.py --reduction jax_prefix` can train the port
with JAX's sums (`use_jax_reduction`). The cumulative sums are PyTorch's,
not XLA's: the rounding differs in its details, not in its size.
"""

from __future__ import annotations

import contextlib
import math

import torch

BUCKET = 1 << 20  # the flagship run's instance bucket (runs/flagship_r5.log)
RECORDS_PER_ROW = 16  # 8-lane records per 128-lane row
GROUP_ROWS = 256
SPLIT = (slice(0, 8), slice(8, 9))  # JAX's two grad tables: mx..g, then b


def _prefix_sums(x: torch.Tensor, bounds: torch.Tensor, bucket: int) -> torch.Tensor:
    """Differences of exclusive prefix sums of x (M, <= 8) at `bounds`
    (N + 1,), in reduce_grads_presort's order of operations."""
    m, width = x.shape
    gpr, grec = RECORDS_PER_ROW, 8
    g = torch.zeros((bucket, grec), dtype=torch.float32, device=x.device)
    g[:m, :width] = x
    r0 = bucket // gpr
    rows = g.reshape(r0, gpr * grec)
    if r0 % GROUP_ROWS == 0 and r0 > GROUP_ROWS:
        cs_in = torch.cumsum(rows.reshape(r0 // GROUP_ROWS, GROUP_ROWS, -1), dim=1)
        tot = cs_in[:, -1, :]
        off = torch.cumsum(tot, dim=0) - tot
        cs = (cs_in + off[:, None, :]).reshape(r0, -1)
    else:
        cs = torch.cumsum(rows, dim=0)
    r, k = bounds // gpr, bounds % gpr
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    a_prev = torch.where((r > 0)[:, None], cs[torch.clamp(r - 1, min=0)], zero).reshape(-1, gpr, grec)
    a_cur = cs[torch.clamp(r, max=r0 - 1)].reshape(-1, gpr, grec)
    lane = torch.arange(gpr, device=x.device)
    within = torch.where(lane[None, :, None] < k[:, None, None], a_cur - a_prev, zero).sum(dim=1)
    p = a_prev.sum(dim=1) + within
    return (p[1:] - p[:-1])[:, :width]


def jax_prefix_reduce(inst: torch.Tensor, rank_start: torch.Tensor, order: torch.Tensor,
                      bucket: int = BUCKET) -> torch.Tensor:
    """(N, 9) per-Gaussian sums of the (M, 9) presort instance records, by
    JAX's prefix differences; `bucket` is raised to the next power of two
    above M when M exceeds it, as the JAX trainer regrows its bucket."""
    m = inst.shape[0]
    bucket = max(bucket, 1 << math.ceil(math.log2(max(m, 1))))
    seg = torch.cat([_prefix_sums(inst[:, lanes], rank_start, bucket) for lanes in SPLIT], dim=1)
    grads = torch.empty_like(seg)
    grads[order] = seg
    return grads


@contextlib.contextmanager
def use_jax_reduction(bucket: int = BUCKET):
    """Within the block, the raster backward sums with JAX's prefix
    differences in place of Kernel C's reduction (and of its plain
    version on the CPU). Kernel C's walk still runs on the card."""
    from sgs_tpu_torch.ops import flat_raster

    saved = flat_raster.reduce_runs, flat_raster.reduce_runs_plain

    def reduce(inst, rank_start, order):
        return jax_prefix_reduce(inst, rank_start, order, bucket)

    flat_raster.reduce_runs = flat_raster.reduce_runs_plain = reduce
    try:
        yield
    finally:
        flat_raster.reduce_runs, flat_raster.reduce_runs_plain = saved
