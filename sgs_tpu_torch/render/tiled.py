"""Tiled rasterizer: binning and the differentiable raster call. Port of
`sgs_tpu/render/tiled.py` (binning and the custom VJP `_rasterize_core`).

Gaussians are depth-sorted once, stably on (depth, index), with culled
ones at +inf. Each visible Gaussian expands into tile rows of its 3-sigma
rectangle; tight culling cuts each row to the exact tile interval where
its alpha can reach 1/255 (`x_tile_interval`). Rows expand into
(Gaussian, tile) instances emitted in depth-rank order, and one stable
sort by tile id then leaves every tile's list in front-to-back order,
which is the order the JAX kernels composite in.

`RasterizeFunction` pairs Kernel A (forward) with Kernel C (backward). The
backward needs, besides the forward's t_final and n_contrib, the binning's
tile-sort permutation and each Gaussian's run of instances in the
depth-rank-major ("presort") order in which they were emitted: Kernel C
writes each instance's gradient record at its presort position and sums
every Gaussian's contiguous run in order, so the result is the same bits
from run to run.

PyTorch runs eagerly, so every array is sized from the real counts: there
are no static buckets and nothing overflows. The TPU-only machinery of the
JAX file (aligned chunk packing, payload lanes, barriers) has no
counterpart here; the chunk-padded rows and row maps that the
forward-raster experiments read are in `ops/rows.py`.
"""

from __future__ import annotations

import torch

from sgs_tpu_torch.core.projection import ALPHA_MIN, TILE, tile_rect, to_i32
from sgs_tpu_torch.ops import flat_raster


def x_tile_interval(mx, my, ca, cb, cc, tau, ty, min_x, max_x, tiles_x: int):
    """Exact tile x-interval [txlo, txhi) of the region where a Gaussian
    can reach alpha >= 1/255 within tile row `ty`, intersected with the
    rect [min_x, max_x). P(dx, dy) = 0.5(ca dx^2 + cc dy^2) + cb dx dy <=
    tau = ln(op*255) is convex, so per tile row its x-set is an interval
    in closed form. Elementwise f32, padded 0.1 px against rounding
    (conservative only). Empty rows give txlo >= txhi."""
    y0 = (16 * ty).to(torch.float32) - my
    y1 = y0 + 15.0
    cc_s = torch.clamp_min(cc, 1e-12)
    det = torch.clamp_min(ca * cc - cb * cb, 1e-30)
    x_ext = torch.sqrt(torch.clamp_min(2.0 * tau * cc / det, 0.0))
    slope = cb / cc_s

    def roots(dyb):
        # roots of 0.5 ca x^2 + cb dyb x + (0.5 cc dyb^2 - tau) = 0
        a = torch.clamp_min(ca, 1e-12)
        b = cb * dyb
        c = 0.5 * cc * dyb * dyb - tau
        disc = b * b - 2.0 * a * c
        ok = disc >= 0
        sq = torch.sqrt(torch.clamp_min(disc, 0.0))
        return ok, (-b + sq) / a, (-b - sq) / a

    inf = torch.full_like(mx, float("inf"))
    dy_right = -slope * x_ext
    dyb_r = torch.minimum(torch.maximum(dy_right, y0), y1)
    okr, hi_r, _ = roots(dyb_r)
    xhi = torch.where(dyb_r == dy_right, x_ext, torch.where(okr, hi_r, -inf))
    dy_left = slope * x_ext
    dyb_l = torch.minimum(torch.maximum(dy_left, y0), y1)
    okl, _, lo_l = roots(dyb_l)
    xlo = torch.where(dyb_l == dy_left, -x_ext, torch.where(okl, lo_l, inf))

    nonempty = (tau > 0.0) & (xhi >= xlo)
    txlo = torch.maximum(to_i32((mx + xlo - 0.1) / TILE), min_x)
    txhi = torch.minimum(to_i32((mx + xhi + 0.1) / TILE) + 1, max_x)
    txlo = txlo.clamp(0, tiles_x)
    txhi = txhi.clamp(0, tiles_x)
    zero = torch.zeros_like(txlo)
    return torch.where(nonempty, txlo, zero), torch.where(nonempty, txhi, zero)


def _expand(counts: torch.Tensor):
    """For run lengths `counts`: (owner run of each element, its rank in the run)."""
    dev = counts.device
    owner = torch.repeat_interleave(torch.arange(counts.shape[0], device=dev), counts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(owner.shape[0], device=dev) - starts[owner]
    return owner, rank


def bin_gaussians(mean2d, conic, opacity, depth, radius, valid,
                  width: int, height: int, tight: bool = True) -> dict:
    """Tile-sorted instance lists. Returns point_list (M,) int32 Gaussian
    ids, tile_start/tile_end (T,) int32, schedule (T,) int32 (the tiles
    by list length, longest first, stably: the order in which Kernels A
    and C hand tiles to blocks, so the longest lists start first and do
    not trail the grid), tiles_x, tiles_y, n_rows (the
    (Gaussian, tile-row) count) and, for the backward, perm (M,) int64
    (presort position of each tile-sorted instance), rank_start (N+1,)
    int64 (presort run of each depth rank) and order (N,) int64 (depth
    rank -> Gaussian id). tight=False keeps the full 3-sigma rect rows
    (the reference binning): the tests use it to show that tight culling
    leaves the composited image as it is."""
    dev = mean2d.device
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    num_tiles = tiles_x * tiles_y

    ok = valid & (radius > 0)
    min_x, max_x, min_y, max_y = tile_rect(mean2d, radius.to(torch.float32), tiles_x, tiles_y)
    zero = torch.zeros_like(min_y)
    counts_h = torch.where(ok & (max_x > min_x), max_y - min_y, zero)

    depth_key = torch.where(ok, depth, torch.full_like(depth, float("inf")))
    order = torch.sort(depth_key, stable=True).indices

    # level 1: depth-ordered (Gaussian, tile row) rows
    run, rank = _expand(counts_h[order].long())
    row_g = order[run]
    ty = min_y[row_g] + rank.to(torch.int32)
    if tight:
        tau = torch.log(torch.clamp_min(opacity, 1e-12) * (1.0 / ALPHA_MIN))
        txlo, txhi = x_tile_interval(
            mean2d[row_g, 0], mean2d[row_g, 1], conic[row_g, 0], conic[row_g, 1],
            conic[row_g, 2], tau[row_g], ty, min_x[row_g], max_x[row_g], tiles_x,
        )
    else:
        txlo, txhi = min_x[row_g], max_x[row_g]
    width_r = torch.clamp_min(txhi - txlo, 0)

    # level 2: (Gaussian, tile) instances, still in depth-rank order
    inst_row, inst_rank = _expand(width_r.long())
    tile_id = ty[inst_row].long() * tiles_x + txlo[inst_row].long() + inst_rank
    tile_sorted, perm = torch.sort(tile_id, stable=True)
    point_list = row_g[inst_row][perm].to(torch.int32).contiguous()

    per_tile = torch.bincount(tile_sorted, minlength=num_tiles)
    tile_end = torch.cumsum(per_tile, 0)
    tile_start = tile_end - per_tile
    schedule = torch.argsort(per_tile, descending=True, stable=True)
    per_rank = torch.bincount(run[inst_row], minlength=order.shape[0])
    rank_start = torch.cat([per_rank.new_zeros(1), torch.cumsum(per_rank, 0)])
    return {
        "point_list": point_list,
        "tile_start": tile_start.to(torch.int32).contiguous(),
        "tile_end": tile_end.to(torch.int32).contiguous(),
        "schedule": schedule.to(torch.int32).contiguous(),
        "tiles_x": tiles_x,
        "tiles_y": tiles_y,
        "n_rows": int(row_g.shape[0]),
        "perm": perm.contiguous(),
        "rank_start": rank_start.contiguous(),
        "order": order.contiguous(),
    }


def kernel_args(bins: dict, mean2d, conic, opacity, rgb, width: int, height: int) -> tuple:
    """Kernel A's arguments, in the order `flat_raster.rasterize_tiles`
    takes them: the bins and one (N, 12) record per Gaussian, conic a, b,
    c, opacity, mean x, y, r, g, b and three zeros."""
    pad = torch.zeros((mean2d.shape[0], 3), dtype=torch.float32, device=mean2d.device)
    records = torch.cat([conic, opacity[:, None], mean2d, rgb, pad], dim=1).to(torch.float32)
    return (
        bins["tile_start"], bins["tile_end"], bins["point_list"], bins["schedule"],
        records.contiguous(), width, height,
    )


class RasterizeFunction(torch.autograd.Function):
    """Binning and Kernel A forward, Kernel C backward: the counterpart of
    the custom VJP `_rasterize_core`.

    forward(mean2d, depth, conic, rgb, opacity, radius, valid, bg, width,
    height, aux) returns the (3, H, W) image color + t_final * bg and puts
    n_instances, t_final, n_contrib and the bins into the dict `aux`.
    backward returns gradients for mean2d, conic, rgb, opacity and bg
    (d bg = sum over pixels of t_final * dC) and None for depth, radius,
    valid and the static arguments."""

    @staticmethod
    def forward(ctx, mean2d, depth, conic, rgb, opacity, radius, valid, bg, width, height, aux):
        bins = bin_gaussians(mean2d, conic, opacity, depth, radius, valid, width, height)
        args = kernel_args(bins, mean2d, conic, opacity, rgb, width, height)
        color, t_final, n_contrib = flat_raster.rasterize_tiles(*args)
        bg32 = bg.to(torch.float32)
        image = color + t_final[None] * bg32[:, None, None]
        ctx.save_for_backward(*args[:5], t_final, n_contrib, bg32, bins["perm"],
                              bins["rank_start"], bins["order"])
        ctx.size = (width, height)
        ctx.bg_dtype = bg.dtype
        aux.update(n_instances=int(bins["point_list"].shape[0]), t_final=t_final,
                   n_contrib=n_contrib, bins=bins)
        return image

    @staticmethod
    def backward(ctx, d_image):
        (tile_start, tile_end, point_list, schedule, records, t_final, n_contrib, bg,
         perm, rank_start, order) = ctx.saved_tensors
        width, height = ctx.size
        dc = d_image.to(torch.float32).contiguous()
        grads = flat_raster.rasterize_tiles_backward(
            tile_start, tile_end, point_list, schedule, records, width, height,
            t_final, n_contrib, dc, bg, perm, rank_start, order,
        )
        d_bg = torch.sum(t_final[None] * dc, dim=(1, 2)).to(ctx.bg_dtype)
        return (grads[:, 0:2], None, grads[:, 2:5], grads[:, 6:9], grads[:, 5],
                None, None, d_bg, None, None, None)


def rasterize_tiled(mean2d, depth, conic, rgb, opacity, radius, valid, bg,
                    width: int, height: int):
    """Bin, composite with Kernel A, then add t_final * bg; differentiable
    through Kernel C.

    Returns ((3, H, W) image, aux) with aux = {n_instances, t_final,
    n_contrib, bins}."""
    aux: dict = {}
    image = RasterizeFunction.apply(mean2d, depth, conic, rgb, opacity, radius, valid, bg,
                                    width, height, aux)
    return image, aux
