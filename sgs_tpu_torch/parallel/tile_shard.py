"""Gaussian-shard + row-band render. Port of `sgs_tpu/parallel/tile_shard.py`.

Gaussians are split over the ranks of a group; each rank projects and
shades its own slice into (n, 12) splat records (mean2d, depth, conic,
rgb, opacity, radius, valid), the records are gathered over the group
(`collectives.gather_records`, whose backward sums each record's
gradient over the bands) and each rank composites its own band of
`band_height` rows. A band is an ordinary `width x band_h` frame: the
records' y is shifted up by the band's first pixel row and the tiled
rasterizer (binning, Kernel A forward, Kernel C backward) runs on it
unchanged. The band images are gathered back into the full image
(`collectives.gather_replicated`).

`render_band` is the per-rank body without collectives: on one card it
renders every band in turn, which is how `chip_smoke.py` checks the band
path. Image height is padded so every band is a whole number of 16-pixel
tile rows.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import TILE, tile_rect
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.parallel.collectives import gather_records, gather_replicated
from sgs_tpu_torch.render.pipeline import project_and_shade
from sgs_tpu_torch.render.tiled import rasterize_tiled

def band_height(height: int, n_dev: int) -> int:
    """Rows per band, padded to whole tiles."""
    tile_rows = -(-height // TILE)
    bands = -(-tile_rows // n_dev)
    return bands * TILE


def row_load_histogram(mean2d, radius, valid, width: int, height: int) -> torch.Tensor:
    """(tiles_y,) rect-binned instance count per tile row: the load signal
    for balanced bands (+w at each Gaussian's first tile row, -w past its
    last, then a cumulative sum)."""
    tiles_x = -(-width // TILE)
    tiles_y = -(-height // TILE)
    min_x, max_x, min_y, max_y = tile_rect(mean2d, radius.to(torch.float32), tiles_x, tiles_y)
    live = valid & (radius > 0) & (max_x > min_x) & (max_y > min_y)
    w = torch.where(live, max_x - min_x, 0).to(torch.int64)
    diff = torch.zeros(tiles_y + 1, dtype=torch.int64, device=mean2d.device)
    diff.index_add_(0, torch.where(live, min_y, tiles_y).long(), w)
    diff.index_add_(0, torch.where(live, max_y, tiles_y).long(), -w)
    return torch.cumsum(diff, 0)[:tiles_y].to(torch.int32)


def balanced_band_offsets(hist, n_bands: int):
    """Band boundaries from a tile-row load histogram, on the host.

    Splits the tile rows into n_bands contiguous bands (each at least one
    tile row) at cumulative-load quantiles. Returns (offsets (n_bands,)
    np.int32, the first tile row of each band; pad_tiles, the most tile
    rows of any band, which every band renders)."""
    hist = np.maximum(np.asarray(hist, np.float64), 0.0)
    tiles_y = hist.shape[0]
    if n_bands > tiles_y:
        # fewer tile rows than bands: one row a band, the last ones empty
        return np.arange(n_bands, dtype=np.int32), 1
    c = np.cumsum(hist)
    total = max(c[-1], 1.0)
    offs = [0]
    for b in range(1, n_bands):
        t = total * b / n_bands
        idx = int(np.searchsorted(c, t, side="left")) + 1
        idx = max(offs[-1] + 1, min(idx, tiles_y - (n_bands - b)))
        offs.append(idx)
    offsets = np.asarray(offs, np.int32)
    rows = np.diff(np.concatenate([offsets, [tiles_y]]))
    return offsets, int(rows.max())


def splat_records(params: Dict[str, torch.Tensor], alive: torch.Tensor, camera: Camera,
                  active_sh_degree: int, tap: Optional[torch.Tensor] = None):
    """Project and shade one slice of the pool into (n, 12) records.

    params are the slice's raw fields; tap (n, 2 or more), zeros, is the
    screen-space tap in NDC units (mean2d += tap[:, :2] * (W/2, H/2)).
    Returns (records, valid (n,) bool, radius (n,) int32)."""
    model = GaussianModel(**params, alive=alive, max_sh_degree=active_sh_degree)
    p = project_and_shade(camera, model.render_inputs(active_sh_degree))
    mean2d = p["mean2d"]
    if tap is not None:
        half = torch.tensor([0.5 * camera.image_width, 0.5 * camera.image_height],
                            dtype=torch.float32, device=mean2d.device)
        mean2d = mean2d + tap[:, :2] * half[None, :]
    rec = torch.cat([
        mean2d, p["depth"][:, None], p["conic"], p["rgb"], p["opacity"][:, None],
        p["radius"].to(torch.float32)[:, None], p["valid"].to(torch.float32)[:, None],
    ], dim=1)
    return rec, p["valid"], p["radius"]


def render_band(all_rec: torch.Tensor, band_offset_px: int, width: int, band_h: int,
                bg: torch.Tensor, valid: Optional[torch.Tensor] = None):
    """Composite one band of rows: the records' y shifted up by
    `band_offset_px`, rendered as a `width x band_h` frame. valid defaults
    to the records' own flag. Returns ((3, band_h, width) image, aux)."""
    if valid is None:
        valid = all_rec[:, 11] > 0.5
    shift = torch.tensor([0.0, float(band_offset_px)], dtype=torch.float32, device=all_rec.device)
    return rasterize_tiled(
        all_rec[:, 0:2] - shift, all_rec[:, 2], all_rec[:, 3:6], all_rec[:, 6:9], all_rec[:, 9],
        all_rec[:, 10].to(torch.int32), valid, bg, width, band_h,
    )


def make_sharded_render(group, width: int, height: int, active_sh_degree: int):
    """Returns render_fn(params, alive, camera, bg, tap=None) -> the full
    (3, height, width) image on every rank of `group`. params and alive
    are this rank's contiguous slice of the pool (rank r holds rows
    [r C/g, (r+1) C/g)); the rank composites band r."""
    n_dev = dist.get_world_size(group)
    bh = band_height(height, n_dev)

    def render_fn(params, alive, camera: Camera, bg, tap=None):
        rec, _, _ = splat_records(params, alive, camera, active_sh_degree, tap)
        all_rec = gather_records(rec, group)
        band = dist.get_rank(group)
        img_band, _ = render_band(all_rec, band * bh, width, bh, bg)
        bands = gather_replicated(img_band[None], group)  # (g, 3, bh, W)
        img = bands.permute(1, 0, 2, 3).reshape(3, n_dev * bh, width)
        return img[:, :height]

    return render_fn
