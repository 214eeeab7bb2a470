"""Bicubic image resize equal to PIL's `Image.resize(size)` bit for bit.

The JAX package resizes every ground-truth image with PIL's default
filter (`sgs_tpu/data/camera_utils.py::pil_to_chw`); the card's machine
has no PIL, so the port carries the same algorithm in numpy
(Pillow's `libImaging/Resample.c` and the RGBA <-> premultiplied
conversions of `libImaging/Convert.c`):

- the same size returns a copy;
- RGBA is premultiplied first (`t = c*a + 128; ((t >> 8) + t) >> 8`) and
  un-premultiplied at the end (alpha 0 or 255 keeps the colour, else
  `clip8((255*c) // a)`);
- the width is resampled first if it changes, then the height if it
  changes, each pass clipped to uint8;
- a pass from n to m pixels: scale n/m, filter scale max(scale, 1),
  support 2 x filter scale; output i takes the taps
  [int(center - support + 0.5), int(center + support + 0.5)) clipped to
  the image, center (i + 0.5) * scale, weighted by Keys' cubic (a = -0.5)
  at (x - center + 0.5) times 1 / filter scale, normalised in float64, quantised
  to 22 fractional bits (rounded away from zero) and summed in integers
  from 2^21, then shifted down by 22 and clipped to 0..255.

Each pass builds an (outputs, taps) index and weight matrix and sums in
int32, as PIL does, one tap at a time over the whole image.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

PRECISION_BITS = 32 - 8 - 2
_A = -0.5  # Keys' cubic, PIL's BICUBIC


def _bicubic(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    near = ((_A + 2.0) * x - (_A + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * _A
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coefficients(n: int, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """(m, taps) input indices and integer weights of a pass from n to m."""
    scale = n / m
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    taps = int(np.ceil(support)) * 2 + 1
    center = (np.arange(m) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), n) - xmin
    x = np.arange(taps)
    live = x[None, :] < xmax[:, None]
    ss = 1.0 / filterscale
    w = np.where(live, _bicubic((x[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss), 0.0)
    total = np.zeros((m, 1))
    for t in range(taps):  # PIL's order: one tap after another
        total[:, 0] += w[:, t]
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    k = np.where(w < 0, -0.5 + w * (1 << PRECISION_BITS), 0.5 + w * (1 << PRECISION_BITS))
    k = np.trunc(k).astype(np.int32)
    idx = np.minimum(xmin[:, None] + x[None, :], n - 1)
    return idx, np.where(live, k, 0)


def _pass(image: np.ndarray, m: int, axis: int) -> np.ndarray:
    """Resample uint8 `image` (H, W, C) to m pixels along `axis` (0 or 1)."""
    idx, k = _coefficients(image.shape[axis], m)
    src = np.ascontiguousarray(np.moveaxis(image, axis, 0)).reshape(image.shape[axis], -1)
    acc = np.full((m, src.shape[1]), 1 << (PRECISION_BITS - 1), np.int32)
    tap = np.empty_like(acc)
    for t in range(idx.shape[1]):  # a few taps; each a gather over the whole image
        np.multiply(src[idx[:, t]], k[:, t, None], out=tap)
        acc += tap
    rest = np.moveaxis(image, axis, 0).shape[1:]
    acc = acc.reshape((m,) + rest)
    return np.moveaxis(np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8), 0, axis)


def _tables() -> Tuple[np.ndarray, np.ndarray]:
    """(alpha, colour) -> premultiplied and un-premultiplied colour."""
    c = np.arange(256, dtype=np.int32)[None, :]
    a = np.arange(256, dtype=np.int32)[:, None]
    t = c * a + 128
    pre = ((t >> 8) + t) >> 8
    keep = (a == 0) | (a == 255)
    unpre = np.where(keep, c, np.clip((255 * c) // np.where(keep, 1, a), 0, 255))
    return pre.astype(np.uint8), unpre.astype(np.uint8)


_PREMULTIPLY, _UNPREMULTIPLY = _tables()


def _apply_alpha(image: np.ndarray, table: np.ndarray) -> np.ndarray:
    out = image.copy()
    out[:, :, :3] = table[image[:, :, 3:4], image[:, :, :3]]
    return out


def resize(image: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 for size (w, h), as
    `PIL.Image.fromarray(image).resize(size)` (C = 1: PIL's "L" mode,
    given as `image[:, :, 0]`)."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (1, 3, 4):
        raise ValueError(f"resize takes (H, W, 1|3|4) uint8 images (gray, RGB, RGBA), "
                         f"got {image.dtype} {image.shape}")
    w, h = int(size[0]), int(size[1])
    if w < 1 or h < 1:
        raise ValueError(f"resize to {w}x{h}: the size must be positive")
    if image.shape[:2] == (h, w):
        return image.copy()
    rgba = image.shape[2] == 4
    out = _apply_alpha(image, _PREMULTIPLY) if rgba else image
    if w != out.shape[1]:
        out = _pass(out, w, axis=1)
    if h != out.shape[0]:
        out = _pass(out, h, axis=0)
    return _apply_alpha(out, _UNPREMULTIPLY) if rgba else out
