"""Raster forward (Kernel A) and backward (Kernel C): wrappers, plain
PyTorch versions, launch counts.

Kernel A replaces `sgs_tpu/ops/pallas/flat_raster.py::forward_flat`;
Kernel C replaces `backward_flat` there and the per-Gaussian reduction
after it (`reduce_grads_presort`). Input is the
tile-sorted instance list from `render/tiled.py`: per tile the range
[tile_start, tile_end) of `point_list`, whose entries are Gaussian ids in
front-to-back depth order; `schedule` (T,) int32, the order in which the
kernels' blocks take the tiles (binning gives longest list first; any
permutation of the tiles gives the same bits); and `records` (N, 12)
f32, one 48-byte row per Gaussian: conic a, b, c, opacity, pixel mean x,
y, r, g, b and three zeros (`REC_*` below), so each kernel stages a record
with three 16-byte copies.

Outputs: color (3,H,W), t_final (H,W) and n_contrib (H,W) int32, the
1-based position in the tile's list of the last instance each pixel
composited (the CUDA reference convention).

The backward takes the image cotangent dC (3,H,W), the forward's t_final
and n_contrib, and the binning's tile-sort permutation `perm` (presort
position of each tile-sorted instance), `rank_start` (N+1,) (the presort
run of each depth rank's instances) and `order` (depth rank -> Gaussian
id). It returns (N, 9) per-Gaussian gradients [d mean x, d mean y,
d conic a, b, c, d opacity, d r, g, b]; d bg is the caller's (it is
sum(t_final * dC)).

On a CUDA tensor each wrapper launches its hand-written kernel
(`csrc/flat_raster.cu`, `csrc/flat_raster_backward.cu`); on a CPU tensor
it runs the plain version. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from sgs_tpu_torch.core.projection import ALPHA_MAX, ALPHA_MIN, TILE, TRANSMITTANCE_EPS
from sgs_tpu_torch.ops.build import INT, PTR, CudaKernel

KERNEL = CudaKernel(
    "flat_raster.cu",
    {"flat_raster_forward": [PTR] * 5 + [INT] * 4 + [PTR] * 4},
    extra_flags=("--fmad=false",),
)

BACKWARD = CudaKernel(
    "flat_raster_backward.cu",
    {
        "flat_raster_backward": [PTR] * 10 + [INT] * 4 + [PTR] * 2,
        "flat_raster_reduce": [PTR] * 3 + [INT] + [PTR] * 2,
    },
    extra_flags=("--fmad=false",),
)

# floats per Gaussian record: conic a, b, c, opacity, x, y, r, g, b, 0, 0, 0
REC_WIDTH = 12

# f32 operations per instance-pixel pair the kernel walks (2 subtractions,
# 9 for the quadratic, exp counted as 1, the alpha product, clamp and 3
# tests, 2 transmittance ops, the weight and 6 for the colour sums).
OPS_PER_PAIR = 26
# Kernel C, per instance-pixel pair below n_contrib: the 17 operations
# that recompute power, q and alpha and test them, 2 for u and T_i, 5 for
# dC . c, 1 for w, 3 for dL/dalpha, 2 for the suffix, 2 for g_power, 9 for
# the terms and 9 adds that reduce them.
OPS_PER_PAIR_BWD = 50
N_GRADS = 9


def _check(tile_start, tile_end, point_list, schedule, records, width, height):
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    expect = {
        "tile_start": (tile_start, torch.int32, (tiles_x * tiles_y,)),
        "tile_end": (tile_end, torch.int32, (tiles_x * tiles_y,)),
        "point_list": (point_list, torch.int32, (point_list.shape[0],)),
        "schedule": (schedule, torch.int32, (tiles_x * tiles_y,)),
        "records": (records, torch.float32, (records.shape[0], REC_WIDTH)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != records.device:
            raise ValueError(f"{name} is on {t.device}, records on {records.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return tiles_x, tiles_y


def rasterize_tiles(tile_start, tile_end, point_list, schedule, records,
                    width: int, height: int):
    """Composite the tile lists. Returns (color, t_final, n_contrib)."""
    tiles_x, tiles_y = _check(tile_start, tile_end, point_list, schedule, records, width, height)
    if records.device.type == "cpu":
        return rasterize_tiles_plain(tile_start, tile_end, point_list, schedule, records, width, height)
    if records.device.type != "cuda":
        raise ValueError(f"unsupported device {records.device}")
    dev = records.device
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    t_final = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    KERNEL.launch(
        "flat_raster_forward",
        tile_start.data_ptr(), tile_end.data_ptr(), point_list.data_ptr(), schedule.data_ptr(),
        records.data_ptr(), width, height, tiles_x, tiles_y,
        color.data_ptr(), t_final.data_ptr(), n_contrib.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return color, t_final, n_contrib


def _longest_first(schedule: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """`schedule` stably re-sorted by `lengths`, longest first: itself when
    it already is longest first, as binning's is."""
    schedule = schedule.long()
    return schedule[torch.argsort(lengths[schedule], descending=True, stable=True)]


def rasterize_tiles_plain(tile_start, tile_end, point_list, schedule, records,
                          width: int, height: int):
    """The same function as the kernel, vectorised over tiles and pixels
    and sequential over each tile's list, with the kernel's arithmetic
    op for op. Tiles are visited longest list first, so the tiles still
    walking at step j are a prefix; the output does not depend on the
    tile order."""
    dev = records.device
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    num_tiles = tiles_x * tiles_y
    counts = tile_end - tile_start
    order = _longest_first(schedule, counts)
    counts_sorted = counts[order].tolist()
    starts = tile_start[order].long()

    lx = torch.arange(TILE * TILE, device=dev) % TILE
    ly = torch.arange(TILE * TILE, device=dev) // TILE
    px_i = (order % tiles_x)[:, None] * TILE + lx[None, :]
    py_i = (order // tiles_x)[:, None] * TILE + ly[None, :]
    px, py = px_i.to(torch.float32), py_i.to(torch.float32)

    trans = torch.ones((num_tiles, TILE * TILE), dtype=torch.float32, device=dev)
    col = torch.zeros((num_tiles, 3, TILE * TILE), dtype=torch.float32, device=dev)
    last = torch.zeros((num_tiles, TILE * TILE), dtype=torch.int32, device=dev)
    done = (px_i >= width) | (py_i >= height)

    live = num_tiles
    step = 0
    while live > 0:
        while live > 0 and counts_sorted[live - 1] <= step:
            live -= 1
        if live == 0:
            break
        g = point_list[starts[:live] + step].long()
        rec = records[g]
        dx = rec[:, 4:5] - px[:live]
        dy = rec[:, 5:6] - py[:live]
        ca, cb, cc, op = rec[:, 0:1], rec[:, 1:2], rec[:, 2:3], rec[:, 3:4]
        power = (-0.5 * ca * dx - cb * dy) * dx + (-0.5 * cc) * dy * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        t_run = trans[:live]
        ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done[:live]
        test_t = t_run * (1.0 - alpha)
        stop = ok & (test_t < TRANSMITTANCE_EPS)
        inc = ok & ~stop
        w = t_run * alpha
        col[:live] = torch.where(inc[:, None, :], col[:live] + rec[:, 6:9, None] * w[:, None, :],
                                 col[:live])
        trans[:live] = torch.where(inc, test_t, t_run)
        last[:live] = torch.where(inc, step + 1, last[:live])
        done[:live] |= stop
        step += 1
        if step % 64 == 0 and bool(done[:live].all()):
            break

    def to_image(tiles: torch.Tensor, channels: int) -> torch.Tensor:
        full = torch.empty_like(tiles)
        full[order] = tiles
        img = full.reshape(tiles_y, tiles_x, channels, TILE, TILE)
        img = img.permute(2, 0, 3, 1, 4).reshape(channels, tiles_y * TILE, tiles_x * TILE)
        return img[:, :height, :width].contiguous()

    color = to_image(col, 3)
    t_final = to_image(trans[:, None, :], 1)[0]
    n_contrib = to_image(last[:, None, :], 1)[0]
    return color, t_final, n_contrib


def _tiles(img: torch.Tensor, tiles_x: int, tiles_y: int, fill) -> torch.Tensor:
    """(C, H, W) -> (tiles, C, 256) in the kernels' pixel order, padded
    with `fill` past the image."""
    c, h, w = img.shape
    full = torch.full((c, tiles_y * TILE, tiles_x * TILE), fill, dtype=img.dtype, device=img.device)
    full[:, :h, :w] = img
    full = full.reshape(c, tiles_y, TILE, tiles_x, TILE).permute(1, 3, 0, 2, 4)
    return full.reshape(tiles_y * tiles_x, c, TILE * TILE)


def _check_backward(t_final, n_contrib, dc, bg, perm, rank_start, order, width, height, n, m):
    expect = {
        "t_final": (t_final, torch.float32, (height, width)),
        "n_contrib": (n_contrib, torch.int32, (height, width)),
        "dc": (dc, torch.float32, (3, height, width)),
        "bg": (bg, torch.float32, (3,)),
        "perm": (perm, torch.int64, (m,)),
        "rank_start": (rank_start, torch.int64, (n + 1,)),
        "order": (order, torch.int64, (n,)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != dc.device:
            raise ValueError(f"{name} is on {t.device}, dc on {dc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rasterize_tiles_backward(tile_start, tile_end, point_list, schedule, records,
                             width: int, height: int, t_final, n_contrib, dc, bg,
                             perm, rank_start, order) -> torch.Tensor:
    """Kernel C: per-Gaussian (N, 9) gradients of the composited colour."""
    tiles_x, tiles_y = _check(tile_start, tile_end, point_list, schedule, records, width, height)
    n, m = records.shape[0], point_list.shape[0]
    _check_backward(t_final, n_contrib, dc, bg, perm, rank_start, order, width, height, n, m)
    args = (tile_start, tile_end, point_list, schedule, records, width, height,
            t_final, n_contrib, dc, bg, perm, rank_start, order)
    if records.device.type == "cpu":
        return rasterize_tiles_backward_plain(*args)
    if records.device.type != "cuda":
        raise ValueError(f"unsupported device {records.device}")
    inst = torch.empty((m, N_GRADS), dtype=torch.float32, device=records.device)
    raster_backward_walk(args, inst)
    return reduce_runs(inst, rank_start, order)


def raster_backward_walk(args: tuple, inst: torch.Tensor) -> None:
    """Kernel C's first launch: the (M, 9) instance gradients into `inst`
    at their presort positions. It counts no launch: `reduce_runs`, which
    completes the result, counts Kernel C's one."""
    (tile_start, tile_end, point_list, schedule, records, width, height,
     t_final, n_contrib, dc, bg, perm, _, _) = args
    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    BACKWARD.launch(
        "flat_raster_backward",
        tile_start.data_ptr(), tile_end.data_ptr(), point_list.data_ptr(), schedule.data_ptr(),
        perm.data_ptr(), records.data_ptr(),
        t_final.data_ptr(), n_contrib.data_ptr(), dc.data_ptr(), bg.data_ptr(),
        width, height, tiles_x, tiles_y, inst.data_ptr(),
        torch.cuda.current_stream(records.device).cuda_stream, count=False,
    )


def reduce_runs(inst: torch.Tensor, rank_start: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Kernel C's second launch: each depth rank's presort run of `inst`
    summed (in `reduce_runs_plain`'s order) and scattered to its Gaussian.
    Counts one launch of Kernel C."""
    n = order.shape[0]
    grads = torch.empty((n, N_GRADS), dtype=torch.float32, device=inst.device)
    BACKWARD.launch("flat_raster_reduce", inst.data_ptr(), rank_start.data_ptr(),
                    order.data_ptr(), n, grads.data_ptr(),
                    torch.cuda.current_stream(inst.device).cuda_stream)
    return grads


def rasterize_tiles_backward_plain(tile_start, tile_end, point_list, schedule, records,
                                   width: int, height: int, t_final, n_contrib, dc, bg,
                                   perm, rank_start, order) -> torch.Tensor:
    """The same function as Kernel C with its arithmetic op for op:
    vectorised over tiles and pixels, back to front over each list, the
    per-instance sums in the kernel's order (warp butterfly, then the 8
    warps in turn), then each Gaussian's presort run summed as
    `reduce_runs_plain` says. The output does not depend on the tile order."""
    dev = records.device
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    num_tiles = tiles_x * tiles_y
    m = point_list.shape[0]

    trans = _tiles(t_final[None], tiles_x, tiles_y, 1.0)[:, 0]
    last = _tiles(n_contrib[None], tiles_x, tiles_y, 0)[:, 0]
    dct = _tiles(dc, tiles_x, tiles_y, 0.0)
    max_last = last.max(dim=1).values
    tiles = _longest_first(schedule, max_last)
    max_sorted = max_last[tiles].tolist()
    starts = tile_start[tiles].long()
    trans, last, dct = trans[tiles], last[tiles], dct[tiles]
    d0, d1, d2 = dct[:, 0], dct[:, 1], dct[:, 2]
    suffix = trans * (d0 * bg[0] + d1 * bg[1] + d2 * bg[2])

    lx = torch.arange(TILE * TILE, device=dev) % TILE
    ly = torch.arange(TILE * TILE, device=dev) // TILE
    px = ((tiles % tiles_x)[:, None] * TILE + lx[None, :]).to(torch.float32)
    py = ((tiles // tiles_x)[:, None] * TILE + ly[None, :]).to(torch.float32)

    inst = torch.zeros((m, N_GRADS), dtype=torch.float32, device=dev)
    live = 0
    top = max_sorted[0] if max_sorted else 0
    for pos in range(top - 1, -1, -1):
        while live < num_tiles and max_sorted[live] > pos:
            live += 1
        idx = starts[:live] + pos
        g = point_list[idx].long()
        rec = records[g]
        ca, cb, cc, op = rec[:, 0:1], rec[:, 1:2], rec[:, 2:3], rec[:, 3:4]
        dx = rec[:, 4:5] - px[:live]
        dy = rec[:, 5:6] - py[:live]
        power = (-0.5 * ca * dx - cb * dy) * dx + (-0.5 * cc) * dy * dy
        q = op * torch.exp(power)
        alpha = torch.clamp_max(q, ALPHA_MAX)
        ok = (pos < last[:live]) & (power <= 0.0) & (alpha >= ALPHA_MIN)
        t_run, s_run = trans[:live], suffix[:live]
        e0, e1, e2 = d0[:live], d1[:live], d2[:live]
        u = 1.0 - alpha
        t_i = t_run / u
        dcc = e0 * rec[:, 6:7] + e1 * rec[:, 7:8] + e2 * rec[:, 8:9]
        w = t_i * alpha
        g_alpha = t_i * dcc - s_run / u
        suffix[:live] = torch.where(ok, s_run + w * dcc, s_run)
        trans[:live] = torch.where(ok, t_i, t_run)
        g_power = torch.where(q < ALPHA_MAX, q * g_alpha, 0.0)
        t1 = dx * g_power
        t2 = dy * g_power
        terms = torch.stack([g_power, t1, t2, t1 * dx, t1 * dy, t2 * dy, w * e0, w * e1, w * e2], 1)
        v = _butterfly(torch.where(ok[:, None, :], terms, 0.0).reshape(live, N_GRADS, 8, 32))[..., 0]
        s = v[..., 0]
        for warp in range(1, 8):
            s = s + v[..., warp]
        out = torch.stack([
            -(ca[:, 0] * s[:, 1] + cb[:, 0] * s[:, 2]),
            -(cc[:, 0] * s[:, 2] + cb[:, 0] * s[:, 1]),
            -0.5 * s[:, 3], -s[:, 4], -0.5 * s[:, 5], s[:, 0] / op[:, 0],
            s[:, 6], s[:, 7], s[:, 8],
        ], 1)
        inst[perm[idx]] = out
    return reduce_runs_plain(inst, rank_start, order)


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """Sum the last axis (32 lanes) in a warp's xor-butterfly order:
    lane l plus lane l + 16, then + 8, + 4, + 2, + 1; keeps a size-1 axis."""
    for off in (16, 8, 4, 2, 1):
        v = v[..., :off] + v[..., off:2 * off]
    return v


def reduce_runs_plain(inst: torch.Tensor, rank_start: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Kernel C's second launch: each depth rank's presort run summed and
    scattered to its Gaussian. The order depends only on the run's
    length L, as in the kernel's warp per run: lane l (of 32) sums
    elements l, l + 32, l + 64, ... of the run in turn from +0, then the
    32 lane sums are added in the xor-butterfly order. L = 0 gives +0."""
    n, k = order.shape[0], inst.shape[1]
    begin = rank_start[:-1]
    length = rank_start[1:] - begin
    lane = torch.arange(32, device=inst.device)
    acc = torch.zeros((n, 32, k), dtype=torch.float32, device=inst.device)
    rounds = -(-int(length.max()) // 32) if n else 0
    for r in range(rounds):
        live = torch.nonzero(length > 32 * r).squeeze(1)
        pos = 32 * r + lane
        more = pos[None, :] < length[live, None]
        rows = torch.where(more, begin[live, None] + pos[None, :], 0)
        part = acc[live]
        acc[live] = torch.where(more[..., None], part + inst[rows], part)
    sums = _butterfly(acc.transpose(1, 2))[..., 0]
    grads = torch.empty_like(sums)
    grads[order] = sums
    return grads
