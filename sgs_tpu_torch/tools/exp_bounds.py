"""Least H100 times of the Pallas experiments in `scripts/exp_*.py`.

    python -m sgs_tpu_torch.tools.exp_bounds

For each kernel that reaches `pl.pallas_call` there, this prints the bytes
it must move (each input read once, each output written once) and the
operations it does, and the bound: the larger of bytes over 3.35 TB/s and
operations over 67 TFLOP/s in f32 (plus, for the tensor-core contraction of
the `mxu` variant, its flops over 495 TFLOP/s in TF32) (H100 SXM, NVIDIA's
data sheet). The gather kernels' shapes are the scripts' own. The
forward-raster kernels (ported as Kernels E, F and G,
`sgs_tpu_torch/ops/exp_forward.py`) work on the rows and instance-pixel
pairs that the scene fixes: they come from `tools/exp_scene.py` at
1920x1080 with 100,000 Gaussians, projected, binned and packed on the CPU
by the plain PyTorch code, so the tool needs no card (about 10 s). Each
forward kernel reads, of every slot of the rows it walks, only the fields
its mode needs (`exp_forward.FIELDS`: 9 for the scans, 6 for alpha), and
the tile tables, and writes the per-row state, (rows, 256, 8) f32, or
out_cols columns for the ablations. Here every used row counts as walked:
the scans skip rows whose pixels have all saturated, which only a run of
the scan can count (`chip_smoke.py` counts it on the card and passes the
walked rows to `scene_counts`).
"""

from __future__ import annotations

import json

from sgs_tpu_torch.ops import exp_forward, rows as rows_ops
from sgs_tpu_torch.tools import exp_scene

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
F32 = 4
REC = rows_ops.REC


def bound_ms(nbytes: float, ops: float, tf32_ops: float = 0.0) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / F32_OPS_PER_S + tf32_ops / TF32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fixed(name: str, where: str, nbytes: float, ops: float, tf32_ops: float = 0.0, **extra) -> dict:
    ms, by = bound_ms(nbytes, ops, tf32_ops)
    return {"script": where, "kernel": name, "bytes": nbytes, "ops": ops, "bound_ms": ms,
            "bound_by": by, **extra}


def scene_counts(sc: dict, walked=None) -> dict:
    """What a forward variant's bound needs from a scene of
    `tools/exp_scene.py`: `read`, the rows whose records it reads (the rows
    `walked`, (R,) bool, or all rows used), `P`, their instance-pixel pairs,
    `rows`, the rows of state it writes, and `tiles`."""
    read = sc["rows_used"] if walked is None else int(walked.sum())
    return {"read": read, "P": exp_forward.pairs(sc["windows"], sc["n_gaussians"], walked),
            "rows": sc["max_rows"], "tiles": sc["num_tiles"]}


def forward(where: str, what: str, c: dict, mode: str, out_cols: int = 8) -> dict:
    """One forward-raster variant on the counts `c` (`scene_counts`): the
    fields it reads of the rows it walks and the tile tables in, the
    per-row state out; `empty` moves nothing."""
    nbytes = 0
    if mode != "empty":
        nbytes = (c["read"] * rows_ops.CHUNK * exp_forward.FIELDS[mode] * F32 + 12 * c["tiles"]
                  + c["rows"] * rows_ops.TILE_PIXELS * out_cols * F32)
    ops = exp_forward.OPS_PER_PAIR[mode] * c["P"]
    tf32 = exp_forward.TF32_FLOPS_PER_PAIR.get(mode, 0) * c["P"]
    return fixed(f"{what}, {mode}, out_cols {out_cols}", where, nbytes, ops, tf32,
                 slots_read=c["read"] * rows_ops.CHUNK, P=c["P"])


def rows(width: int = 1920, height: int = 1080, n: int = 100_000) -> list:
    gather_rows = 16128 * 128  # exp_vmem_gather.py ROWS x CHUNK ids
    m = 1_019_904  # exp_dma_gather.py M
    src = 2_064_384  # exp_gather_layout.py SRC
    c = scene_counts(exp_scene.build_scene(width, height, n, 0, "cpu"))
    fwd = [forward("scripts/exp_fwd.py:210", "forward variant (Kernel E)", c, mode)
           for mode in exp_forward.SCANS]
    abl = [forward("scripts/exp_fwd2.py:84", "structural ablation (Kernel F)", c, mode, oc)
           for mode, oc in (("empty", 8), ("outonly", 8), ("alpha", 8), ("alpha", 1))]
    tr = [forward("scripts/exp_transposed.py:147", "transposed forward (Kernel G)", c, mode)
          for mode in ("hs", "mxu")]
    return fwd + abl + [
        fixed("vector gather from a VMEM table, summed", "scripts/exp_vmem_gather.py:46",
              gather_rows * F32 + 100_000 * REC * F32 + 128 * REC * F32, gather_rows * REC),
        fixed("BlockSpec pipeline over the padded gather", "scripts/exp_dma_gather.py:62",
              gather_rows * REC * F32 + 128 * REC * F32, gather_rows * REC),
        fixed("in-kernel DMA of each row's window", "scripts/exp_dma_gather.py:117",
              (m + 128) * REC * F32 + 16128 * F32 + 128 * REC * F32, gather_rows * REC),
        fixed("identity copy of a (2,064,384, 16) table", "scripts/exp_gather_layout.py:39",
              2 * src * 16 * F32, 0),
        fixed("identity copy of a (2,064,384, 8) table", "scripts/exp_gather_layout.py:39",
              2 * src * 8 * F32, 0),
    ] + tr


def main() -> None:
    for row in rows():
        print(json.dumps(row))


if __name__ == "__main__":
    main()
