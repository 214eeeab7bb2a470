"""Row packing of the tile-sorted instance list: the chunk-padded rows that
the forward-raster experiments (Kernels E, F and G, `ops/exp_forward.py`)
read. Port of `num_rows`, `row_maps`, `tile_ranges` and `pack_rows` in
`sgs_tpu/ops/pallas/flat_raster.py` and of `_attr_records` in
`sgs_tpu/render/tiled.py`.

Each tile's depth-ordered list is padded to whole rows of CHUNK instances;
the rows of all tiles follow one another in tile order. A row holds CHUNK
records of REC f32: x, y, conic a, b, c, opacity, r, g, b, the Gaussian id
as f32 and six zeros. Padding lanes hold the sentinel record (zeros, id N),
whose opacity 0 keeps them out of every sum.

The JAX package sizes these arrays from static buckets; here `max_rows`
is the rows the view needs, rounded up to a whole number of `krows`
steps, and nothing overflows.
"""

from __future__ import annotations

import torch

CHUNK = 64  # instances per row
REC = 16  # f32 per instance record (10 used)
KROWS = 8  # rows per grid step of the TPU kernels
TILE_PIXELS = 256


def num_rows(max_instances: int, num_tiles: int, krows: int = KROWS) -> int:
    """Worst-case rows: every tile's list padded to a chunk boundary,
    rounded up to a whole number of `krows` steps."""
    r = max_instances // CHUNK + num_tiles
    return -(-r // krows) * krows


def tile_ranges(tile_sorted: torch.Tensor, num_tiles: int):
    """Per-tile [start, end) of a sorted tile-id array."""
    tiles = torch.arange(num_tiles, dtype=tile_sorted.dtype, device=tile_sorted.device)
    start = torch.searchsorted(tile_sorted, tiles, side="left").to(torch.int32)
    end = torch.searchsorted(tile_sorted, tiles, side="right").to(torch.int32)
    return start, end


def _fill(at: torch.Tensor, vals: torch.Tensor, max_rows: int) -> torch.Tensor:
    """Scatter `vals` at rows `at` by max, then carry the running max down:
    the value of the tile that owns each row (tiles that share a start row
    are empty but for the largest)."""
    marks = torch.zeros(max_rows, dtype=torch.int32, device=at.device)
    keep = at < max_rows
    marks.scatter_reduce_(0, at[keep].long(), vals[keep].to(torch.int32), "amax")
    return torch.cummax(marks, 0).values


def row_maps(chunk_row_start, n_chunks, rows_used: int, num_tiles: int, max_rows: int):
    """Row -> tile, tile-first and tile-last maps. Returns (row_tile
    (num_tiles on rows past rows_used), row_first, row_last, the owning
    tile's first row, row_valid)."""
    dev = chunk_row_start.device
    rowv = torch.arange(max_rows, dtype=torch.int32, device=dev)
    tiles = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    row_tile_c = _fill(chunk_row_start, tiles, max_rows).clamp(0, num_tiles - 1)
    f_crs = _fill(chunk_row_start, chunk_row_start, max_rows)
    row_valid = rowv < rows_used
    row_first = row_valid & (rowv == f_crs)
    next_crs = torch.cat([f_crs[1:], torch.full((1,), 2**30, dtype=torch.int32, device=dev)])
    row_last = row_valid & (
        (rowv + 1 == torch.clamp_max(next_crs, rows_used))
        | (rowv + 1 == rows_used)
        | (rowv == max_rows - 1)
    )
    row_tile = torch.where(row_valid, row_tile_c, torch.full_like(row_tile_c, num_tiles))
    return row_tile, row_first.to(torch.int32), row_last.to(torch.int32), f_crs, row_valid


def attr_records(mean2d, conic, rgb, opacity, point_list) -> torch.Tensor:
    """(M+1, REC) records in tile-sorted instance order: x, y, conic a, b,
    c, opacity, r, g, b, the Gaussian id as f32, zeros; row M is the
    sentinel (zeros, id N)."""
    n = mean2d.shape[0]
    if n >= 1 << 24:
        raise ValueError("the f32 id column is exact only below 2^24 Gaussians")
    f32 = dict(dtype=torch.float32, device=mean2d.device)
    attr = torch.cat([
        mean2d.to(torch.float32), conic.to(torch.float32), opacity.to(torch.float32)[:, None],
        rgb.to(torch.float32), torch.arange(n, **f32)[:, None], torch.zeros((n, REC - 10), **f32),
    ], dim=1)
    sentinel = torch.zeros((1, REC), **f32)
    sentinel[0, 9] = float(n)
    return torch.cat([attr[point_list.long()], sentinel])


def pack_rows(attr_sorted, tile_start, tile_end, krows: int = KROWS) -> dict:
    """Chunk-pad the tile-sorted records into rows.

    attr_sorted (M+1, REC) from `attr_records`; tile_start/tile_end (T,)
    int32 the tiles' ranges in it. Returns a dict: packed (max_rows*CHUNK,
    REC) f32 instance-major rows, windows (max_rows, CHUNK) int32 Gaussian
    ids, row_tile, row_first, row_last (max_rows,) int32, chunk_row_start
    and n_chunks (T,) int32, tile_start (T,), rows_used and max_rows."""
    m = attr_sorted.shape[0] - 1
    num_tiles = tile_start.shape[0]
    dev = attr_sorted.device
    counts = tile_end - tile_start
    n_chunks = ((counts + CHUNK - 1) // CHUNK).to(torch.int32)
    chunk_row_start = (torch.cumsum(n_chunks, 0) - n_chunks).to(torch.int32)
    rows_used = int(n_chunks.sum())
    max_rows = max(krows, -(-rows_used // krows) * krows)
    row_tile, row_first, row_last, f_crs, row_valid = row_maps(
        chunk_row_start, n_chunks, rows_used, num_tiles, max_rows)
    rowv = torch.arange(max_rows, dtype=torch.int32, device=dev)
    f_ts = _fill(chunk_row_start, tile_start, max_rows)
    f_te = _fill(chunk_row_start, tile_end, max_rows)
    starts = f_ts + (rowv - f_crs) * CHUNK
    src = starts[:, None] + torch.arange(CHUNK, dtype=torch.int32, device=dev)[None, :]
    live = row_valid[:, None] & (src < f_te[:, None])
    src = torch.where(live, src, torch.full_like(src, m))
    rows = attr_sorted[src.long()]
    return {
        "packed": rows.reshape(max_rows * CHUNK, REC).contiguous(),
        "windows": rows[:, :, 9].to(torch.int32),
        "row_tile": row_tile, "row_first": row_first, "row_last": row_last,
        "chunk_row_start": chunk_row_start, "n_chunks": n_chunks,
        "tile_start": tile_start, "rows_used": rows_used, "max_rows": max_rows,
    }


def field_major(packed: torch.Tensor) -> torch.Tensor:
    """(R*CHUNK, REC) instance-major rows -> (R*REC, CHUNK) field-major
    rows, the layout `scripts/exp_fwd.py` and `exp_fwd2.py` read."""
    r = packed.shape[0] // CHUNK
    return packed.reshape(r, CHUNK, REC).transpose(1, 2).reshape(r * REC, CHUNK).contiguous()
