"""Inputs of the gather experiments, made as the scripts make them, and the
steps that the scripts leave to XLA.

Each maker draws with numpy's `default_rng(seed)` in its script's order,
for any size, then moves the arrays to `device`:
- `vmem_inputs`: `scripts/exp_vmem_gather.py:33-35`, a (n, 16) normal
  table, then rows * 128 ids in [0, n);
- `dma_inputs`: `scripts/exp_dma_gather.py:34-41`, a (m + 128, 16) normal
  attribute table (128 rows of tail pad for windows that start at m),
  then the row starts min(cumsum(integers(1, 128, rows)) & ~7, m);
- `layout_inputs`: `scripts/exp_gather_layout.py:29-33`, out_rows ids in
  [0, src), then a (src, w) normal table for each width w, 16 before 8.

`pack` and `layout_gather` are the scripts' XLA gathers, plain PyTorch
indexing here as there.
"""

from __future__ import annotations

import numpy as np
import torch

from sgs_tpu_torch.ops.gather import CHUNK, M, N, OUT_ROWS, REC, ROWS, SRC, WIDTHS


def vmem_inputs(n: int = N, rows: int = ROWS, seed: int = 0, device="cpu") -> tuple:
    """(table (n, 16) f32, ids (rows * 128,) int32)."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(n, REC)).astype(np.float32)
    ids = rng.integers(0, n, size=(rows * CHUNK,)).astype(np.int32)
    return torch.as_tensor(table, device=device), torch.as_tensor(ids, device=device)


def dma_inputs(m: int = M, rows: int = ROWS, seed: int = 0, device="cpu") -> tuple:
    """(attr (m + 128, 16) f32, starts (rows,) int32): 8-aligned,
    monotone, about 63 rows apart, the last ones clamped to m."""
    rng = np.random.default_rng(seed)
    attr = rng.normal(size=(m + CHUNK, REC)).astype(np.float32)
    starts = np.minimum(np.cumsum(rng.integers(1, CHUNK, size=rows)) & ~7, m).astype(np.int32)
    return torch.as_tensor(attr, device=device), torch.as_tensor(starts, device=device)


def layout_inputs(out_rows: int = OUT_ROWS, src: int = SRC, seed: int = 0, device="cpu") -> tuple:
    """(idx (out_rows,) int32, {width: table (src, width) f32}), the
    tables row-major as drawn."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, src, size=out_rows).astype(np.int32)
    tables = {}
    for rec in WIDTHS:
        tables[rec] = torch.as_tensor(rng.normal(size=(src, rec)).astype(np.float32), device=device)
    return torch.as_tensor(idx, device=device), tables


def pack(attr: torch.Tensor, starts: torch.Tensor, m: int = M) -> torch.Tensor:
    """`exp_dma_gather.py::pack`: each row's 128-row window, indices
    clamped to m, (rows * 128, 16)."""
    src = starts.long()[:, None] + torch.arange(CHUNK, device=starts.device)[None, :]
    return attr[torch.clamp_max(src, m)].reshape(-1, REC)


def layout_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`exp_gather_layout.py`'s `t[idx]`: rows of `table` by id."""
    return torch.index_select(table, 0, idx)
