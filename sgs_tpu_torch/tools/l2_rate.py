"""The card's L2 read rate, for Kernel H's bound.

    python -m sgs_tpu_torch.tools.l2_rate [--mib 24 --passes 20]

Reads a buffer of MIB MiB of ones, which the 50 MB L2 holds, PASSES times
per launch with the streaming-read probe `csrc/l2_read.cu` (16-byte
loads cached in the L2 and not in L1, a few blocks per SM), after one
launch that brings the buffer into the L2, and prints the bytes read per
second (device time, `tools/ssim_times.py::time_ms`) with the card's name
and power limit. `chip_smoke.py` phase 9 takes H's bound from this rate
(`tools/exp_bounds.py::vmem_gather_row`). Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from sgs_tpu_torch.ops.build import INT, PTR, CudaKernel
from sgs_tpu_torch.tools import exp_scene

KERNEL = CudaKernel("l2_read.cu", {"l2_read_launch": [PTR, INT, INT, INT, PTR, PTR]})
BLOCKS_PER_SM = 4


def l2_read_rate(dev, mib: int = 24, passes: int = 20) -> dict:
    """Bytes per second of streaming reads from an L2-resident buffer on
    the card `dev`: {"bytes_per_s", "ms" (one launch), "bytes" (read per
    launch), "card"}."""
    if torch.device(dev).type != "cuda":
        raise ValueError("l2_read_rate measures the card: give a CUDA device")
    from sgs_tpu_torch.tools.ssim_times import time_ms

    n4 = mib * 2**20 // 16
    buf = torch.ones(n4 * 4, dtype=torch.float32, device=dev)
    sink = torch.zeros(1, dtype=torch.float32, device=dev)
    blocks = BLOCKS_PER_SM * torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        KERNEL.launch("l2_read_launch", buf.data_ptr(), n4, passes, blocks, sink.data_ptr(), stream)

    ms = time_ms(launch, 20)
    nbytes = passes * n4 * 16
    return {"bytes_per_s": nbytes / (ms * 1e-3), "ms": ms, "bytes": nbytes, "buffer_bytes": n4 * 16,
            "card": exp_scene.card_line()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="The card's L2 read rate")
    ap.add_argument("--mib", type=int, default=24)
    ap.add_argument("--passes", type=int, default=20)
    args = ap.parse_args(None if argv is None else [str(a) for a in argv])
    out = l2_read_rate(torch.device("cuda"), args.mib, args.passes)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
