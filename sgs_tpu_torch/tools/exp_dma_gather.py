"""Kernels I and J: a pipeline over a pre-packed gather against a DMA of
each row's window. Port of `scripts/exp_dma_gather.py`.

    python -m sgs_tpu_torch.tools.exp_dma_gather [--m M --rows ROWS --device cuda]

Makes the script's inputs (`tools/gather_inputs.py::dma_inputs`, seed 0: a
(M + 128, 16) f32 table, then ROWS 8-aligned row starts), times the pack gather
(`gather_inputs.pack`, plain PyTorch indexing as XLA's gather was), Kernel
I on the packed rows (variant A) and Kernel J on the table and the starts
(variant B), in device ms (`tools/ssim_times.py::time_ms`, "not measured"
on the CPU). Prints the script's check `A == B:`, which is False by
design: A is the last grid step's sum of 8 rows, B the sum over every
row (and near the end the two read different rows: the pack clamps its
indices to M, B's windows read the tail pad). Then each kernel's max |err|
against its plain version, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.ops import build, gather
from sgs_tpu_torch.tools import exp_scene, gather_inputs


def _total(a, b) -> str:
    return "not measured" if a is None or b is None else f"{a + b:.4f}"


def run(dev, m: int = gather.M, rows: int = gather.ROWS) -> dict:
    attr, starts = gather_inputs.dma_inputs(m, rows, device=dev)
    packed = gather_inputs.pack(attr, starts, m)
    gather_ms = exp_scene.device_ms(lambda: gather_inputs.pack(attr, starts, m), dev)
    ra = gather.packed_sum(packed)
    a_ms = exp_scene.device_ms(lambda: gather.packed_sum(packed), dev)
    rb = gather.dma_gather(attr, starts)
    print("A == B:", bool(torch.allclose(ra, rb, rtol=1e-5)), flush=True)
    b_ms = exp_scene.device_ms(lambda: gather.dma_gather(attr, starts), dev)
    err_i = float((gather.packed_sum_steps(packed) - gather.packed_sum_steps_plain(packed)).abs().max())
    err_j = float((rb - gather.dma_gather_plain(attr, starts)).abs().max())
    print(f"XLA pack gather:          {exp_scene.fmt_ms(gather_ms)}", flush=True)
    print(f"A (BlockSpec on padded):  {exp_scene.fmt_ms(a_ms)}   total {_total(gather_ms, a_ms)}",
          flush=True)
    print(f"B (in-kernel row DMA):    {exp_scene.fmt_ms(b_ms)}", flush=True)
    print(f"    against their plain versions: Kernel I max |err| {err_i:.2e}, Kernel J "
          f"{err_j:.2e}; {int((starts == m).sum())} of {rows} rows start at M", flush=True)
    print(exp_scene.card_line(), flush=True)
    return {"attr": attr, "starts": starts, "packed": packed, "a": ra, "b": rb,
            "gather_ms": gather_ms, "a_ms": a_ms, "b_ms": b_ms, "err_i": err_i, "err_j": err_j}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Kernels I and J: packed pipeline against window DMA")
    ap.add_argument("--m", type=int, default=gather.M)
    ap.add_argument("--rows", type=int, default=gather.ROWS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(None if argv is None else [str(a) for a in argv])
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        build.build_all([gather.KERNEL])
    return run(dev, args.m, args.rows)


if __name__ == "__main__":
    main(sys.argv[1:])
