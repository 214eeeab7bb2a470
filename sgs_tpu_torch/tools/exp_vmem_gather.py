"""Kernel H: sums of records gathered by id from a 100,000-row table. Port
of `scripts/exp_vmem_gather.py`.

    python -m sgs_tpu_torch.tools.exp_vmem_gather [--n N --rows ROWS --device cuda]

Makes the script's inputs (`tools/gather_inputs.py::vmem_inputs`, seed 0:
a (N, 16) f32 table, then ROWS * 128 ids), runs Kernel H and prints the script's
line with device ms (`tools/ssim_times.py::time_ms`, "not measured" on the
CPU) and its own check. `ok=` holds the Pallas output, the last grid
step's sum, against the sum over every step, as the script does: the
program assigns each step's sum to the same output block, so it prints
False by design. Then Kernel H's max |err| against its plain version over
every step's sum, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys

import torch

from sgs_tpu_torch.core.device import resolve_device
from sgs_tpu_torch.ops import build, gather
from sgs_tpu_torch.ops.gather import CHUNK, KROWS, REC
from sgs_tpu_torch.tools import exp_scene, gather_inputs


def run(dev, n: int = gather.N, rows: int = gather.ROWS) -> dict:
    table, ids = gather_inputs.vmem_inputs(n, rows, device=dev)
    steps = gather.vmem_gather_steps(table, ids)
    out = steps[-1]
    used = ids[: steps.shape[0] * KROWS * CHUNK].long()
    ref = table[used].view(-1, KROWS, CHUNK, REC).sum(dim=(0, 1))
    ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-3))
    ms = exp_scene.device_ms(lambda: gather.vmem_gather(table, ids), dev)
    err = float((steps - gather.vmem_gather_steps_plain(table, ids)).abs().max())
    print(f"in-kernel VMEM gather: {exp_scene.fmt_ms(ms)} for {rows * CHUNK} rows, ok={ok}", flush=True)
    print(f"    Kernel H against its plain version: max |err| {err:.2e} over {steps.shape[0]} "
          f"step sums", flush=True)
    print(exp_scene.card_line(), flush=True)
    return {"table": table, "ids": ids, "out": out, "ok": ok, "ms": ms, "err": err}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Kernel H: gathers from an L2-resident table")
    ap.add_argument("--n", type=int, default=gather.N)
    ap.add_argument("--rows", type=int, default=gather.ROWS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(None if argv is None else [str(a) for a in argv])
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        build.build_all([gather.KERNEL])
    return run(dev, args.n, args.rows)


if __name__ == "__main__":
    main(sys.argv[1:])
