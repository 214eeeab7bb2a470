"""Adaptive density control on the capacity-padded pool. Port of
`sgs_tpu/models/densify.py`.

Clone (gradient >= threshold, max scale <= percent_dense * extent: an exact
copy) and split (larger ones: n_split children drawn from N(0, diag(scale^2))
rotated by the parent, log-scale log(scale / (0.8 n_split)), the parent
pruned). Pruning (opacity < min_opacity, and with a screen-size threshold
the world-size test) applies to existing slots and children. Pruned slots
get the benign dead values; surviving children go into free slots in
order (pass A: clones and split child 0, then split children 1..), and
their Adam moments are zeroed. The statistics reset afterwards.

As in the JAX package, `use_screen_size_prune=False` keeps the reference's
quirk: its densification postfix zeroes max_radii2D before the prune test
runs, so the `max_radii2D > max_screen_size` term never fires.

The split noise is `noise` (a list of n_split (C, 3) standard normal
arrays, so tests can hand in JAX's draws) or drawn from `generator`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from sgs_tpu_torch.core import transforms
from sgs_tpu_torch.models.gaussians import (
    DEAD_LOG_SCALE,
    DEAD_OPACITY_LOGIT,
    PARAM_FIELDS,
    DensifyStats,
    GaussianModel,
)
from sgs_tpu_torch.train.optim import AdamState

SPLIT_SCALE_DIV = 0.8
PRUNE_WS_FACTOR = 0.1


def _bmask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (like.dim() - 1))


def _benign_row_defaults(model: GaussianModel) -> dict:
    dev = model.device
    k = model.features_rest.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "xyz": torch.zeros((3,), **f32),
        "features_dc": torch.zeros((1, 3), **f32),
        "features_rest": torch.zeros((k, 3), **f32),
        "scaling": torch.full((3,), DEAD_LOG_SCALE, **f32),
        "rotation": torch.tensor([1.0, 0.0, 0.0, 0.0], **f32),
        "opacity": torch.full((1,), DEAD_OPACITY_LOGIT, **f32),
    }


@torch.no_grad()
def densify_and_prune(
    model: GaussianModel,
    adam: AdamState,
    stats: DensifyStats,
    max_grad: float,
    min_opacity: float,
    extent: float,
    max_screen_size: float,
    percent_dense: float,
    n_split: int = 2,
    use_screen_size_prune: bool = False,
    noise: Optional[Sequence[torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[GaussianModel, AdamState, DensifyStats, dict]:
    """Returns (model, adam, zeroed stats, info counts)."""
    cap = model.capacity
    dev = model.device
    alive = model.alive

    grads = torch.nan_to_num(stats.xyz_gradient_accum[:, 0] / stats.denom[:, 0], nan=0.0)
    scales = model.get_scaling
    max_scale = torch.max(scales, dim=-1).values
    over_thresh = alive & (grads >= max_grad)
    clone_mask = over_thresh & (max_scale <= percent_dense * extent)
    split_mask = over_thresh & (max_scale > percent_dense * extent)

    if noise is None:
        noise = [torch.randn((cap, 3), generator=generator, dtype=torch.float32, device=dev)
                 for _ in range(n_split)]
    if len(noise) != n_split:
        raise ValueError(f"need {n_split} noise arrays, got {len(noise)}")
    rot = transforms.quat_to_rotmat(model.rotation)

    def split_child(z):
        z = torch.as_tensor(z, dtype=torch.float32, device=dev) * scales
        child = model.params()
        child["xyz"] = model.xyz + torch.einsum("cij,cj->ci", rot, z)
        child["scaling"] = torch.log(scales / (SPLIT_SCALE_DIV * n_split))
        return child

    split0 = split_child(noise[0])
    pass_a = {
        f: torch.where(_bmask(clone_mask, split0[f]), getattr(model, f), split0[f])
        for f in PARAM_FIELDS
    }
    passes = [(pass_a, clone_mask | split_mask)]
    for j in range(1, n_split):
        passes.append((split_child(noise[j]), split_mask))

    opac = model.get_opacity[:, 0]
    size_on = max_screen_size > 0.0
    size_terms = (max_scale > PRUNE_WS_FACTOR * extent) & size_on
    if use_screen_size_prune:
        size_terms = size_terms | ((stats.max_radii2d > max_screen_size) & size_on)
    existing_prune = (alive & ((opac < min_opacity) | size_terms)) | split_mask

    def child_keep(child, valid):
        c_op = torch.sigmoid(child["opacity"][:, 0])
        c_ms = torch.max(torch.exp(child["scaling"]), dim=-1).values
        prune = (c_op < min_opacity) | ((c_ms > PRUNE_WS_FACTOR * extent) & size_on)
        return valid & ~prune

    passes = [(child, child_keep(child, valid)) for child, valid in passes]

    new_alive = alive & ~existing_prune
    defaults = _benign_row_defaults(model)
    params = {
        f: torch.where(_bmask(existing_prune, getattr(model, f)), defaults[f][None], getattr(model, f))
        for f in PARAM_FIELDS
    }

    free_slots = torch.nonzero(~new_alive).flatten()
    num_free = free_slots.shape[0]
    newcomer = torch.zeros((cap,), dtype=torch.bool, device=dev)
    offset = 0
    n_alloc = 0
    for child, valid in passes:
        rank = torch.cumsum(valid.to(torch.int64), 0) - 1 + offset
        ok = valid & (rank < num_free)
        src = torch.nonzero(ok).flatten()
        dest = free_slots[rank[src]]
        for f in PARAM_FIELDS:
            params[f][dest] = child[f][src]
        newcomer[dest] = True
        n_alloc += int(src.shape[0])
        offset += int(valid.sum())

    new_alive = new_alive | newcomer
    for f in PARAM_FIELDS:
        adam = adam.zero_slots(f, newcomer)
    info = {
        "n_cloned": int(clone_mask.sum()),
        "n_split": int(split_mask.sum()),
        "n_pruned": int(existing_prune.sum()),
        "n_dropped_overflow": offset - n_alloc,
        "num_alive": int(new_alive.sum()),
    }
    new_model = model.with_params(params)
    new_model.alive = new_alive
    return new_model, adam, DensifyStats.zeros(cap, dev), info


@torch.no_grad()
def reset_opacity(model: GaussianModel, adam: AdamState) -> Tuple[GaussianModel, AdamState]:
    """opacity <- inverse_sigmoid(min(opacity, 0.01)) on alive slots, with
    the opacity moments zeroed."""
    new_op = transforms.inverse_sigmoid(torch.clamp_max(model.get_opacity, 0.01))
    opacity = torch.where(model.alive[:, None], new_op, model.opacity)
    return model.with_params({"opacity": opacity}), adam.zero_field("opacity")
