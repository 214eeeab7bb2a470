"""Raster forward (Kernel A): wrapper, plain PyTorch version, launch count.

Replaces `sgs_tpu/ops/pallas/flat_raster.py::forward_flat`. Input is the
tile-sorted instance list from `render/tiled.py`: per tile the range
[tile_start, tile_end) of `point_list`, whose entries are Gaussian ids in
front-to-back depth order. Per-Gaussian records are `xy` (N,2) pixel
means, `conic_op` (N,4) = conic a, b, c and opacity, and `rgb` (N,3).

Outputs: color (3,H,W), t_final (H,W) and n_contrib (H,W) int32, the
1-based position in the tile's list of the last instance each pixel
composited (the CUDA reference convention).

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/flat_raster.cu`; on a CPU tensor it runs the plain version. There is
no fallback from one to the other.
"""

from __future__ import annotations

import torch

from sgs_tpu_torch.core.projection import ALPHA_MAX, ALPHA_MIN, TILE, TRANSMITTANCE_EPS
from sgs_tpu_torch.ops.build import INT, PTR, CudaKernel

KERNEL = CudaKernel(
    "flat_raster.cu",
    {"flat_raster_forward": [PTR] * 6 + [INT] * 4 + [PTR] * 4},
    extra_flags=("--fmad=false",),
)

# f32 operations per instance-pixel pair the kernel walks (2 subtractions,
# 9 for the quadratic, exp counted as 1, the alpha product, clamp and 3
# tests, 2 transmittance ops, the weight and 6 for the colour sums).
OPS_PER_PAIR = 26


def _check(tile_start, tile_end, point_list, xy, conic_op, rgb, width, height):
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    n = xy.shape[0]
    expect = {
        "tile_start": (tile_start, torch.int32, (tiles_x * tiles_y,)),
        "tile_end": (tile_end, torch.int32, (tiles_x * tiles_y,)),
        "point_list": (point_list, torch.int32, (point_list.shape[0],)),
        "xy": (xy, torch.float32, (n, 2)),
        "conic_op": (conic_op, torch.float32, (n, 4)),
        "rgb": (rgb, torch.float32, (n, 3)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != xy.device:
            raise ValueError(f"{name} is on {t.device}, xy on {xy.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return tiles_x, tiles_y


def rasterize_tiles(tile_start, tile_end, point_list, xy, conic_op, rgb,
                    width: int, height: int):
    """Composite the tile lists. Returns (color, t_final, n_contrib)."""
    tiles_x, tiles_y = _check(tile_start, tile_end, point_list, xy, conic_op, rgb, width, height)
    if xy.device.type == "cpu":
        return rasterize_tiles_plain(tile_start, tile_end, point_list, xy, conic_op, rgb, width, height)
    if xy.device.type != "cuda":
        raise ValueError(f"unsupported device {xy.device}")
    dev = xy.device
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    t_final = torch.empty((height, width), dtype=torch.float32, device=dev)
    n_contrib = torch.empty((height, width), dtype=torch.int32, device=dev)
    KERNEL.launch(
        "flat_raster_forward",
        tile_start.data_ptr(), tile_end.data_ptr(), point_list.data_ptr(),
        xy.data_ptr(), conic_op.data_ptr(), rgb.data_ptr(),
        width, height, tiles_x, tiles_y,
        color.data_ptr(), t_final.data_ptr(), n_contrib.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return color, t_final, n_contrib


def rasterize_tiles_plain(tile_start, tile_end, point_list, xy, conic_op, rgb,
                          width: int, height: int):
    """The same function as the kernel, vectorised over tiles and pixels
    and sequential over each tile's list, with the kernel's arithmetic
    op for op. Tiles are visited longest list first, so the tiles still
    walking at step j are a prefix."""
    dev = xy.device
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    num_tiles = tiles_x * tiles_y
    counts = tile_end - tile_start
    order = torch.argsort(counts, descending=True, stable=True)
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
        m = xy[g]
        co = conic_op[g]
        dx = m[:, 0:1] - px[:live]
        dy = m[:, 1:2] - py[:live]
        ca, cb, cc, op = co[:, 0:1], co[:, 1:2], co[:, 2:3], co[:, 3:4]
        power = (-0.5 * ca * dx - cb * dy) * dx + (-0.5 * cc) * dy * dy
        alpha = torch.clamp_max(op * torch.exp(power), ALPHA_MAX)
        t_run = trans[:live]
        ok = (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done[:live]
        test_t = t_run * (1.0 - alpha)
        stop = ok & (test_t < TRANSMITTANCE_EPS)
        inc = ok & ~stop
        w = t_run * alpha
        col[:live] = torch.where(inc[:, None, :], col[:live] + rgb[g][:, :, None] * w[:, None, :], col[:live])
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
