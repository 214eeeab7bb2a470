"""Hybrid 2D-mesh training: camera data parallelism x Gaussian sharding.
Port of `sgs_tpu/parallel/hybrid.py`.

Mesh axes ("data", "gauss"): rank (d, g) trains camera d of the step's
batch and owns slice g of the pool (rows [g C/G, (g+1) C/G) of every
capacity-leading tensor: parameters, alive, Adam moments, statistics).
Per rank: project and shade the slice with the screen-space tap added,
gather the records over "gauss", cull them to the band's owned tile rows
(and, with compaction, keep only those), composite band g, gather the
bands over "gauss" and assemble camera d's image, on which every gauss
rank computes the same L1 + SSIM loss. The backward runs Kernels D and C
on the rank's band; the records' gradients are summed over "gauss" by the
gather's backward; the parameter gradients are averaged over "data"
only; the densification statistics are summed (max for the radii) over
"data". Adam then updates each slice where it lives.

Balanced bands: `balance_from_sample` splits the tile rows at quantiles
of a sampled load histogram; every band renders `pad_tiles` tile rows
from its offset and the assembly writes the bands in ascending order, so
a band's overhang is overwritten by the next band's owned rows (and gets
no gradient). The JAX package sizes static per-band buckets from sampled
cameras (`band_bucket_sample`, `band_record_cap`); the port sizes every
array from the real counts and keeps only their `py_rng.sample` calls
(`band_sizing_draws`), so the trainer pops the views JAX pops.
"""

from __future__ import annotations

import random
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from sgs_tpu_torch.core import transforms
from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import TILE, project_gaussians, to_i32
from sgs_tpu_torch.models.gaussians import PARAM_FIELDS, DensifyStats, GaussianModel
from sgs_tpu_torch.parallel.collectives import all_gather_tensor, gather_records, gather_replicated
from sgs_tpu_torch.parallel.data_parallel import camera_at, flatten_grads, group_means, reduce_stats
from sgs_tpu_torch.parallel.mesh import axis
from sgs_tpu_torch.parallel.tile_shard import (balanced_band_offsets, band_height,
                                               row_load_histogram, render_band, splat_records)
from sgs_tpu_torch.train.loop import TrainState, apply_grads, view_grads, zero_nonfinite
from sgs_tpu_torch.train.optim import AdamState

def equal_band_offsets(height: int, n_bands: int):
    """Equal-height bands: (first tile row of each band, tile rows a band)."""
    bh_t = band_height(height, n_bands) // TILE
    return np.arange(n_bands, dtype=np.int32) * bh_t, bh_t


def band_ownership_cull(rec_y, rec_radius, rec_valid, off_t: int, nxt_t: int, tiles_y: int):
    """Keep the records whose tile-row extent meets the band's owned rows
    [off_t, nxt_t): the band's overhang is overwritten at assembly, so
    only records that straddle its boundary need to stay."""
    r = rec_radius
    gy0 = to_i32((rec_y - r) / TILE).clamp(0, tiles_y)
    gy1 = to_i32((rec_y + r + TILE - 1) / TILE).clamp(0, tiles_y)
    return rec_valid & (gy1 > off_t) & (gy0 < nxt_t)


def band_compact(all_rec: torch.Tensor, band_valid: torch.Tensor) -> torch.Tensor:
    """The band-valid rows of the gathered records, in order (differentiable:
    the other rows get no gradient). JAX compacts into a static buffer
    (`_band_compact`); eager arrays need no cap, so nothing overflows."""
    return all_rec[torch.nonzero(band_valid).flatten()]


def assemble_bands(bands: torch.Tensor, offsets, height: int, pad_tiles: int) -> torch.Tensor:
    """(n_bands, 3, bh, W) band images -> (3, height, W), each band written
    at its offset in ascending order so the next band overwrites a band's
    overhang (which then gets no gradient)."""
    n_bands, _, bhp, w = bands.shape
    # equal bands of many ranks may start past the last tile row
    rows_t = max(-(-height // TILE), max(int(o) for o in offsets)) + pad_tiles
    canvas = bands.new_zeros((3, rows_t * TILE, w))
    for i in range(n_bands):
        y0 = int(offsets[i]) * TILE
        canvas[:, y0:y0 + bhp] = bands[i]
    return canvas[:, :height]


def band_records(all_rec: torch.Tensor, off_t: int, nxt_t: int, tiles_y: int, cull: bool = True,
                 compact: bool = False):
    """One band's records from the gathered ones: (records, valid). Valid
    is the records' own flag, culled with `cull` to those that meet the
    band's owned tile rows [off_t, nxt_t); `compact` then keeps only the
    valid rows."""
    valid = all_rec[:, 11] > 0.5
    if cull:
        valid = band_ownership_cull(all_rec[:, 1], all_rec[:, 10], valid, off_t, nxt_t, tiles_y)
    if compact:
        all_rec = band_compact(all_rec, valid)
        valid = torch.ones(all_rec.shape[0], dtype=torch.bool, device=all_rec.device)
    return all_rec, valid


def _band_layout(height: int, n_gauss: int, band_pad_tiles: int, band_offsets):
    """(offsets, next offsets, pad_tiles) as host ints for one step."""
    tiles_y = -(-height // TILE)
    offsets = equal_band_offsets(height, n_gauss)[0] if band_offsets is None else band_offsets
    offsets = [int(o) for o in offsets]
    pad = band_pad_tiles if band_pad_tiles > 0 else band_height(height, n_gauss) // TILE
    return offsets, offsets[1:] + [tiles_y], pad


def _render_rank_band(rec, group, g_rank, offsets, nxt, pad, width, height, bg, compact):
    """Gather the records, cull and optionally compact them to this rank's
    band, composite the band, gather the bands and assemble the image."""
    band_rec, valid = band_records(gather_records(rec, group), offsets[g_rank], nxt[g_rank],
                                   -(-height // TILE), compact=compact)
    img_band, aux = render_band(band_rec, offsets[g_rank] * TILE, width, pad * TILE, bg, valid)
    bands = gather_replicated(img_band[None], group)
    return assemble_bands(bands, offsets, height, pad), aux


def render_bands(all_rec: torch.Tensor, offsets, pad_tiles: int, width: int, height: int,
                 bg: torch.Tensor, own: bool = False):
    """Every band of one camera rendered in turn on this device and
    assembled: what the ranks of a gauss group compute together, without
    collectives (the one-card check of the band path). own=True culls each
    band's records to its owned tile rows and compacts them, as the hybrid
    step does. Returns ((3, height, width) image, [each band's aux])."""
    tiles_y = -(-height // TILE)
    nxt = [int(o) for o in offsets[1:]] + [tiles_y]
    images, auxes = [], []
    for b, off in enumerate(offsets):
        rec, valid = band_records(all_rec, int(off), nxt[b], tiles_y, cull=own, compact=own)
        img, aux = render_band(rec, int(off) * TILE, width, pad_tiles * TILE, bg, valid)
        images.append(img)
        auxes.append(aux)
    return assemble_bands(torch.stack(images), offsets, height, pad_tiles), auxes


def make_hybrid_render(mesh, width: int, height: int, active_sh_degree: int,
                       band_pad_tiles: int = 0, compact: bool = False):
    """Returns render_fn(params, alive, camera, bg, band_offsets=None) ->
    this rank's camera's (3, height, width) image. params and alive are
    the rank's gauss slice; camera is the rank's camera of the batch.
    band_pad_tiles > 0 with band_offsets (first tile row of each band,
    e.g. from `tile_shard.balanced_band_offsets`) gives balanced bands."""
    g_group, g_rank, n_gauss = axis(mesh, "gauss")

    def render_fn(params, alive, camera: Camera, bg, band_offsets=None):
        offsets, nxt, pad = _band_layout(height, n_gauss, band_pad_tiles, band_offsets)
        rec, _, _ = splat_records(params, alive, camera, active_sh_degree)
        img, _ = _render_rank_band(rec, g_group, g_rank, offsets, nxt, pad, width, height, bg, compact)
        return img

    return render_fn


def balance_from_sample(model: GaussianModel, cameras, py_rng: random.Random, n_bands: int,
                        k: int = 4):
    """(offsets, pad_tiles) for balanced bands: the tile-row load histograms
    of a k-camera sample summed, then split at cumulative-load quantiles."""
    cams = [getattr(c, "camera", c) for c in cameras]
    if len(cams) > k:
        cams = py_rng.sample(cams, k)
    height, width = cams[0].image_height, cams[0].image_width
    cov = transforms.build_covariance(model.get_scaling, model.rotation)
    hist = None
    with torch.no_grad():
        for cam in cams:
            proj = project_gaussians(model.xyz, cov, cam.world_view_transform, cam.full_proj_transform,
                                     cam.tanfovx, cam.tanfovy, width, height)
            valid = (proj["radius"] > 0) & model.alive
            h = row_load_histogram(proj["mean2d"], proj["radius"], valid, width, height).cpu().numpy()
            hist = h if hist is None else hist + h
    return balanced_band_offsets(hist, n_bands)


def band_sizing_draws(py_rng: random.Random, cameras, compact: bool, k: int = 4) -> None:
    """The `sample` calls of JAX's `band_bucket_sample` and, with
    compaction, `band_record_cap`, which size buckets the port does not
    need: the trainer makes them so its views follow JAX's."""
    cams = list(cameras)
    for _ in range(2 if compact else 1):
        if len(cams) > k:
            py_rng.sample(cams, k)


def place_hybrid_state(state: TrainState, mesh) -> TrainState:
    """This rank's slice of a full state: rows [g C/G, (g+1) C/G) of every
    capacity-leading tensor. The gauss size must divide the capacity."""
    _, g, n_gauss = axis(mesh, "gauss")
    cap = state.model.capacity
    assert cap % n_gauss == 0, f"pool capacity {cap} must divide the gauss axis ({n_gauss})"
    lo, hi = g * cap // n_gauss, (g + 1) * cap // n_gauss

    def cut(x):
        return x[lo:hi].clone()

    return _map_state(state, cut)


def gather_hybrid_state(state: TrainState, mesh) -> TrainState:
    """The full state from every rank's slice (a collective over "gauss")."""
    group, _, _ = axis(mesh, "gauss")

    def full(x):
        if x.dtype == torch.bool:
            return all_gather_tensor(x.to(torch.uint8), group).to(torch.bool)
        return all_gather_tensor(x, group)

    return _map_state(state, full)


def _map_state(state: TrainState, fn) -> TrainState:
    m = state.model
    model = GaussianModel(**{f: fn(getattr(m, f)) for f in PARAM_FIELDS}, alive=fn(m.alive),
                          max_sh_degree=m.max_sh_degree)
    adam = AdamState(mu={k: fn(v) for k, v in state.adam.mu.items()},
                     nu={k: fn(v) for k, v in state.adam.nu.items()}, step=dict(state.adam.step))
    s = state.stats
    stats = DensifyStats(xyz_gradient_accum=fn(s.xyz_gradient_accum), denom=fn(s.denom),
                         max_radii2d=fn(s.max_radii2d))
    return TrainState(model=model, adam=adam, stats=stats)


def make_hybrid_train_step(mesh, active_sh_degree: int, width: int, height: int,
                           lambda_dssim: float = 0.2, freeze_xyz: bool = False,
                           apply_update: bool = True, band_pad_tiles: int = 0,
                           compact: bool = False):
    """The training step on the hybrid mesh.

    Call: step(state (this rank's gauss slice), cam_batch (the rank's
    one-camera slice of the batch, `data_parallel.shard_camera_batch`),
    gt_batch (1, 3, H, W), bg, lrs, band_offsets=None) -> (state,
    metrics). band_pad_tiles > 0 with band_offsets gives balanced bands;
    compact=True bins only the band's records (JAX's band_rec_cap > 0)."""
    d_group, _, n_data = axis(mesh, "data")
    g_group, g_rank, n_gauss = axis(mesh, "gauss")

    def step(state: TrainState, cam_batch: Camera, gt_batch: torch.Tensor, bg: torch.Tensor,
             lrs: Dict[str, float], band_offsets=None):
        if gt_batch.shape[0] != 1:
            raise ValueError(f"hybrid trains one camera a data rank, got {gt_batch.shape[0]}")
        camera = camera_at(cam_batch, 0)
        offsets, nxt, pad = _band_layout(height, n_gauss, band_pad_tiles, band_offsets)
        model = state.model

        def render_fn(leaves, tap):
            rec, valid, radius = splat_records(leaves, model.alive, camera, active_sh_degree, tap)
            image, _ = _render_rank_band(rec, g_group, g_rank, offsets, nxt, pad, width, height, bg,
                                         compact)
            return {"render": image, "radii": radius, "visibility_filter": valid & (radius > 0)}

        loss, ll1, param_grads, tap_grad, out = view_grads(model, render_fn, gt_batch[0], lambda_dssim,
                                                           tap_cols=2)
        with torch.no_grad():
            # the mean over "data" of the slice's gradients
            param_grads, loss_mean, l1_mean = group_means(flatten_grads(param_grads, loss, ll1), 1,
                                                          d_group, n_data, model)
            # non-finite guard: the slices' counts of the reduced parameter
            # gradients summed over "gauss", and every rank's tap count
            nf_param, grads = zero_nonfinite([param_grads[f] for f in PARAM_FIELDS])
            # the tap's gradient of the batch's mean loss: this camera's share
            nf_tap, (tap_grad,) = zero_nonfinite([tap_grad / float(n_data)])
            nf_param, nf_tap = nf_param.reshape(1), nf_tap.reshape(1)
            dist.all_reduce(nf_param, group=g_group)
            dist.all_reduce(nf_tap, group=g_group)
            dist.all_reduce(nf_tap, group=d_group)
            local = DensifyStats.zeros(model.capacity, model.device).update(
                tap_grad, out["radii"], out["visibility_filter"])
            new_state = apply_grads(state, dict(zip(PARAM_FIELDS, grads)),
                                    state.stats.merge(reduce_stats(local, d_group)), lrs, freeze_xyz,
                                    apply_update)
        metrics = {"loss": loss_mean, "l1": l1_mean, "overflow": 0,
                   "nonfinite_grads": (nf_param + nf_tap)[0]}
        return new_state, metrics

    return step
