"""Least H100 times of the Pallas experiments in `scripts/exp_*.py`.

    python -m sgs_tpu_torch.tools.exp_bounds

Those scripts are not on any path of the JAX package and are not ported
yet. For each kernel that reaches `pl.pallas_call` there, this prints the
bytes it must move (each input read once, each output written once) and
the f32 operations it does, from the script's own shapes, and the bound:
the larger of bytes over 3.35 TB/s and operations over 67 TFLOP/s (H100
SXM, NVIDIA's data sheet). The forward-kernel variants work on a number
of instances and instance-pixel pairs that depends on the projected
scene; for them it prints the formula and the part that the image
outputs alone fix. Needs no card.
"""

from __future__ import annotations

import json

from sgs_tpu_torch.ops.flat_raster import OPS_PER_PAIR

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F32 = 4
REC = 16  # sgs_tpu/ops/pallas/flat_raster.py: f32 lanes per packed instance


def bound_ms(nbytes: float, ops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fixed(name: str, where: str, nbytes: float, ops: float) -> dict:
    ms, by = bound_ms(nbytes, ops)
    return {"script": where, "kernel": name, "bytes": nbytes, "ops": ops, "bound_ms": ms,
            "bound_by": by}


def forward(where: str, what: str, width: int = 1920, height: int = 1080) -> dict:
    """A forward-kernel variant over S packed instance slots (REC f32 each)
    and P instance-pixel pairs, writing colour, transmittance and count
    per pixel (20 bytes)."""
    out = 20 * width * height
    ms, _ = bound_ms(out, 0)
    return {"script": where, "kernel": what,
            "bound_ms": f"max(({REC * F32} S + {out}) / 3.35e12, {OPS_PER_PAIR} P / 67e12) s; "
                        f"the outputs alone {ms:.4f} ms",
            "S, P": "not measured (1080p, 100,000 Gaussians, from the script's build_inputs)"}


def rows() -> list:
    gather_rows = 16128 * 128  # exp_vmem_gather.py ROWS x CHUNK ids
    m = 1_019_904  # exp_dma_gather.py M
    src = 2_064_384  # exp_gather_layout.py SRC
    return [
        forward("scripts/exp_fwd.py:210", "forward variants (rows per step, MXU cumsum, no cumprod)"),
        forward("scripts/exp_fwd2.py:84", "forward structural ablations (empty, output copies, alpha)"),
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
        forward("scripts/exp_transposed.py:147", "transposed forward (pixels on lanes)"),
    ]


def main() -> None:
    for row in rows():
        print(json.dumps(row))


if __name__ == "__main__":
    main()
