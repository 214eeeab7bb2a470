"""The O(N*P) reference rasterizer: the numerical oracle. Port of
`sgs_tpu/render/reference.py` (`rasterize_sorted`), in plain PyTorch.

Every pixel is tested against every depth-sorted Gaussian, with the CUDA
rasterizer's semantics: a stable depth sort with invalid entries last; a
Gaussian touches only the pixels of the 16x16 tiles inside its radius
rectangle (unbounded when `radius` is None); power > 0 is skipped, alpha
below 1/255 is skipped and alpha is clamped at 0.99; a pixel stops before
the Gaussian that would take its transmittance below 1e-4; the colour is
C + T * bg. Nothing here bins: it shares no code with `render/tiled.py`,
so on the card it checks binning and Kernel A independently.

Pixels go in blocks of `pixel_block` and Gaussians in depth chunks of
`chunk_size`; within a chunk the stop is resolved with a cumulative
product. The result depends on the two sizes only through f32
reordering. The backward comes from autograd, each chunk under
`torch.utils.checkpoint` (the JAX code's `jax.checkpoint`), so a backward
keeps one (P, 3) colour and (P,) transmittance per chunk and recomputes
the chunk's (P, G) tensors, not all of them at once.

Two shortcuts against the JAX code: chunks that hold only invalid
entries (after the sort they are all at the end) are not composited, as
they change nothing; and the transmittance carried to the next chunk is
the cumulative product at the stop, the value the stop test read, where
the JAX code takes a second product of the kept factors (the same value
up to f32 reordering).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from sgs_tpu_torch.core.projection import ALPHA_MAX, ALPHA_MIN, TILE, TRANSMITTANCE_EPS, tile_rect

# 65,536 pixels a block: each (P, 256) f32 temporary is 64 MiB; an 800x800
# view is 10 blocks. `python -m sgs_tpu_torch.tools.oracle_times` on an
# NVIDIA H100 80GB HBM3 at 700 W: flagship test view 0 in 8,636 ms at a
# peak of 0.88 GiB, against 14,632 ms at 16,384 pixels and 8,819 ms and
# 7.35 GiB at the whole frame.
PIXEL_BLOCK = 65536
CHUNK_SIZE = 256


def _composite_chunk(C, T, done, px, py, ptx, pty, tx, ty, m2d, conic, rgb, opac, valid, rect):
    """One depth chunk of G Gaussians over P pixels: (C, T, done) -> the same.
    tx, ty are the tile columns and rows (tiles, 1); ptx, pty each pixel's."""
    g = m2d.shape[0]
    dx = m2d[None, :, 0] - px[:, None]  # (P, G): xy - pixf
    dy = m2d[None, :, 1] - py[:, None]
    power = (-0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
             - conic[None, :, 1] * dx * dy)
    alpha = torch.clamp(opac[None, :] * torch.exp(power), max=ALPHA_MAX)
    # the tile-rect test as two (tiles, G) tables gathered per pixel
    in_x = (tx >= rect[None, :, 0]) & (tx < rect[None, :, 1]) & valid[None, :]
    in_y = (ty >= rect[None, :, 2]) & (ty < rect[None, :, 3])
    live = (power <= 0.0) & (alpha >= ALPHA_MIN) & in_x[ptx] & in_y[pty]
    a = torch.where(live, alpha, 0.0)
    u = 1.0 - a
    s_incl = torch.cumprod(u, dim=1)
    t_after = T[:, None] * s_incl
    # the first Gaussian that would take T below the epsilon is excluded
    # and ends the pixel (CUDA: test before compositing)
    viol = (a > 0.0) & (t_after < TRANSMITTANCE_EPS)
    any_viol = viol.any(dim=1)
    stop = torch.where(any_viol, viol.to(torch.uint8).argmax(dim=1), g)
    stop = torch.where(done, 0, stop)
    keep = torch.arange(g, device=stop.device)[None, :] < stop[:, None]
    s_excl = torch.cat([torch.ones_like(s_incl[:, :1]), s_incl[:, :-1]], dim=1)
    w = torch.where(keep, T[:, None] * s_excl * a, 0.0)
    C = C + w @ rgb
    last = t_after.gather(1, (stop - 1).clamp(min=0)[:, None])[:, 0]
    T = torch.where(stop > 0, last, T)
    return C, T, done | any_viol


def rasterize_sorted(mean2d: torch.Tensor, depth: torch.Tensor, conic: torch.Tensor,
                     rgb: torch.Tensor, opacity: torch.Tensor, valid: torch.Tensor,
                     bg: torch.Tensor, width: int, height: int,
                     radius: Optional[torch.Tensor] = None, chunk_size: int = CHUNK_SIZE,
                     pixel_block: int = PIXEL_BLOCK) -> torch.Tensor:
    """Depth-sort and composite; returns the (3, H, W) image.

    mean2d (N, 2) pixel-space centres (tap included), depth (N,), conic
    (N, 3), rgb (N, 3), opacity (N,), valid (N,) bool, bg (3,). With
    `radius` (N,) each Gaussian composites only into the pixels of the
    tiles inside its radius rectangle (the CUDA binning footprint)."""
    dev = mean2d.device
    dtype = torch.promote_types(torch.promote_types(torch.promote_types(mean2d.dtype, rgb.dtype),
                                                    opacity.dtype), torch.float32)
    n = mean2d.shape[0]
    order = torch.argsort(torch.where(valid, depth, float("inf")), stable=True)
    n_chunks = -(-int(valid.sum()) // chunk_size)
    idx = order[:min(n, n_chunks * chunk_size)]
    pad = n_chunks * chunk_size - idx.shape[0]

    tiles_x, tiles_y = -(-width // TILE), -(-height // TILE)
    if radius is not None:
        rect = torch.stack(tile_rect(mean2d, radius.to(dtype), tiles_x, tiles_y), dim=-1)
    else:
        rect = torch.tensor([0, tiles_x, 0, tiles_y], dtype=torch.int32, device=dev).expand(n, 4)

    def gather_pad(x, dt):
        x = x[idx].to(dt)
        return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x

    m2d, con, col = gather_pad(mean2d, dtype), gather_pad(conic, dtype), gather_pad(rgb, dtype)
    opac, val, rect = gather_pad(opacity, dtype), gather_pad(valid, torch.bool), gather_pad(rect, torch.int32)
    bg = bg.to(dtype)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (m2d, con, col, opac))

    tx = torch.arange(tiles_x, dtype=torch.int32, device=dev)[:, None]
    ty = torch.arange(tiles_y, dtype=torch.int32, device=dev)[:, None]
    total = height * width
    out = []
    for start in range(0, total, pixel_block):
        pix = torch.arange(start, min(start + pixel_block, total), device=dev)
        px, py = (pix % width).to(dtype), (pix // width).to(dtype)
        ptx, pty = (px / TILE).long(), (py / TILE).long()
        C = torch.zeros((pix.shape[0], 3), dtype=dtype, device=dev)
        T = torch.ones((pix.shape[0],), dtype=dtype, device=dev)
        done = torch.zeros((pix.shape[0],), dtype=torch.bool, device=dev)
        for c in range(n_chunks):
            s = slice(c * chunk_size, (c + 1) * chunk_size)
            args = (C, T, done, px, py, ptx, pty, tx, ty, m2d[s], con[s], col[s], opac[s], val[s],
                    rect[s])
            if grad:
                C, T, done = checkpoint(_composite_chunk, *args, use_reentrant=False)
            else:
                C, T, done = _composite_chunk(*args)
        out.append(C + T[:, None] * bg[None, :])
    return torch.cat(out).reshape(height, width, 3).permute(2, 0, 1).contiguous()
