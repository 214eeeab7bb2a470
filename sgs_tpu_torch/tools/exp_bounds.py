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

The gather kernels (ported as Kernels H, I, J and K,
`sgs_tpu_torch/ops/gather.py`) count what the scripts' inputs need, made
at the scripts' sizes on the CPU (`tools/gather_inputs.py`; `chip_smoke.py`
passes the card's copies): H reads the ids of its grid steps and the
table rows they name once and writes every step's (128, 16) partial; I
reads the packed rows of its steps and writes the partials; J reads the
rows its windows cover once, the starts, and writes one (128, 16) sum; K
reads and writes the table. H adds once per gathered element, I and J
twice (rec + rec, then acc +=). H's bound has a second term: it reads
every gathered 64-byte record once, 132 MB at the script's size, from a
table that only the L2 can hold (6.4 MB, 28 times a block's shared
memory), so those bytes over the L2 read rate bound it too. The rate is
the card's, measured by `tools/l2_rate.py` (`chip_smoke.py` passes it);
without the card it is L2_READ_BYTES_PER_S below.
"""

from __future__ import annotations

import json

import torch

from sgs_tpu_torch.ops import exp_forward, gather as gather_ops, rows as rows_ops
from sgs_tpu_torch.tools import exp_scene, gather_inputs

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
# The L2 read rate before the card's measurement: the 5,120 bytes per
# clock of L2 read bandwidth that NVIDIA's A100 white paper states (the
# H100 data sheet gives no L2 figure) at the H100 SXM's 1,980 MHz boost
# clock.
L2_READ_BYTES_PER_S = 5120 * 1.98e9
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


def scan_counts(sc: dict, mode: str) -> dict:
    """`scene_counts` over the rows that the scan of `mode` walks, from its
    plain version's `walked`: hs and mxu skip the same rows, nocp its own
    (its t_run falls only by each row's last factor)."""
    _, info = exp_forward.scan_plain(sc["packed_fm"], sc["chunk_row_start"], sc["n_chunks"],
                                     sc["tiles_x"], mode)
    return scene_counts(sc, info["walked"])


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


def vmem_gather_row(table, ids, l2_bytes_per_s: float = L2_READ_BYTES_PER_S) -> dict:
    """Kernel H: the ids of the grid steps and the table rows they name in,
    every step's partial out; one add per gathered element. The bound is
    the larger of that (`hbm_bound_ms`) and the gathered records' bytes
    (`l2_bytes`, each record once per id) at `l2_bytes_per_s` (`l2_ms`);
    `bound_term` says which."""
    steps = gather_ops.grid_steps(ids.numel() // gather_ops.CHUNK)
    n_ids = steps * gather_ops.KROWS * gather_ops.CHUNK
    used = torch.unique(ids[:n_ids].clamp(0, table.shape[0] - 1)).numel()
    out = steps * gather_ops.CHUNK * REC * F32
    row = fixed("vector gather from a VMEM table, summed (Kernel H)", "scripts/exp_vmem_gather.py:46",
                n_ids * F32 + used * REC * F32 + out, n_ids * REC, table_rows_read=used)
    l2_bytes = n_ids * REC * F32
    l2_ms = l2_bytes / l2_bytes_per_s * 1e3
    row.update(hbm_bound_ms=row["bound_ms"], l2_bytes=l2_bytes, l2_bytes_per_s=l2_bytes_per_s, l2_ms=l2_ms,
               bound_term="hbm")
    if l2_ms > row["bound_ms"]:
        row.update(bound_ms=l2_ms, bound_by="bytes", bound_term="l2")
    return row


def packed_sum_row(packed_rows: int) -> dict:
    """Kernel I: the packed rows of the grid steps in, every step's partial
    out; rec + rec and the add, 2 per element."""
    steps = gather_ops.grid_steps(packed_rows // gather_ops.CHUNK)
    n = steps * gather_ops.KROWS * gather_ops.CHUNK
    return fixed("BlockSpec pipeline over the padded gather (Kernel I)", "scripts/exp_dma_gather.py:62",
                 n * REC * F32 + steps * gather_ops.CHUNK * REC * F32, 2 * n * REC)


def dma_gather_row(attr, starts) -> dict:
    """Kernel J: the attribute rows that the windows cover, once, and the
    starts in, one (128, 16) sum out; 2 operations per element."""
    rows = gather_ops.grid_steps(starts.numel()) * gather_ops.KROWS
    s = torch.unique(starts[:rows].long().clamp(0, attr.shape[0] - gather_ops.CHUNK))
    covered = int(torch.clamp_max(s[1:] - s[:-1], gather_ops.CHUNK).sum()) + gather_ops.CHUNK
    return fixed("in-kernel DMA of each row's window (Kernel J)", "scripts/exp_dma_gather.py:117",
                 covered * REC * F32 + rows * F32 + gather_ops.CHUNK * REC * F32,
                 2 * rows * gather_ops.CHUNK * REC, attr_rows_read=covered)


def identity_row(src: int, rec: int) -> dict:
    """Kernel K: the table in and out."""
    return fixed(f"identity copy of a ({src:,}, {rec}) table (Kernel K)",
                 "scripts/exp_gather_layout.py:39", 2 * src * rec * F32, 0)


def gather_rows(vmem=None, dma=None, src: int = gather_ops.SRC,
                l2_bytes_per_s: float = L2_READ_BYTES_PER_S) -> list:
    """The gather kernels' rows on `vmem` (table, ids) and `dma` (attr,
    starts), made at the scripts' sizes on the CPU when not given; H's L2
    term at `l2_bytes_per_s`."""
    table, ids = vmem if vmem is not None else gather_inputs.vmem_inputs()
    attr, starts = dma if dma is not None else gather_inputs.dma_inputs()
    return [vmem_gather_row(table, ids, l2_bytes_per_s), packed_sum_row(starts.numel() * gather_ops.CHUNK),
            dma_gather_row(attr, starts)] + [identity_row(src, rec) for rec in gather_ops.WIDTHS]


def kernel_a(args, n_contrib) -> dict:
    """Kernel A on its arguments (`render/tiled.py::kernel_args`) and the
    n_contrib it returned: the point list, the 48-byte records, the tile
    ranges and schedule in, 20 bytes a pixel out; OPS_PER_PAIR operations
    for every instance-pixel pair below n_contrib."""
    from sgs_tpu_torch.ops import flat_raster

    nbytes = (4 * args[2].shape[0] + 4 * flat_raster.REC_WIDTH * args[4].shape[0]
              + 12 * args[0].shape[0] + 20 * args[5] * args[6])
    pairs = float(n_contrib.sum())
    return fixed("Kernel A", "sgs_tpu/ops/pallas/flat_raster.py:492", nbytes,
                 flat_raster.OPS_PER_PAIR * pairs, P=pairs)


def rows(width: int = 1920, height: int = 1080, n: int = 100_000) -> list:
    c = scene_counts(exp_scene.build_scene(width, height, n, 0, "cpu"))
    fwd = [forward("scripts/exp_fwd.py:210", "forward variant (Kernel E)", c, mode)
           for mode in exp_forward.SCANS]
    abl = [forward("scripts/exp_fwd2.py:84", "structural ablation (Kernel F)", c, mode, oc)
           for mode, oc in (("empty", 8), ("outonly", 8), ("alpha", 8), ("alpha", 1))]
    tr = [forward("scripts/exp_transposed.py:147", "transposed forward (Kernel G)", c, mode)
          for mode in ("hs", "mxu")]
    return fwd + abl + gather_rows() + tr


def main() -> None:
    for row in rows():
        print(json.dumps(row))


if __name__ == "__main__":
    main()
