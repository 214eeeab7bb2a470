"""Native JPEG decode times of the port it is run from.

    python -m sgs_tpu_torch.tools.jpeg_times [DATA_ROOT]

Decodes, with `ops/jpeg.py::read_jpeg_native`, the 800x800 views of
data/colmap_flagship800_jpg once each and the 4946x3286 frames of
data/jpeg_cases (baseline and progressive) three times each, under
DATA_ROOT (default: this repository), and prints one JSON line: the
number of views, their ms per Mpx and each frame's median ms per Mpx (a
frame the decoder refuses is left out). `chip_smoke.py` phase 13 (a)
takes its decode times from `main`. It uses only `read_jpeg_native`,
which every version of the port has, so `PYTHONPATH=<checkout> python
<this file> <repo>` times an older checkout's decoder on this
repository's files; run on the card's machine, where nvcc builds the
library.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

from sgs_tpu_torch.ops import jpeg as jpeg_ops

BIG = ("flagship_4946x3286_q95_420.jpg", "flagship_4946x3286_q95_420_progressive.jpg")
BIG_MPX = 4946 * 3286 / 1e6
VIEW_MPX = 0.64


def main(root: Path) -> dict:
    jpeg_ops.read_jpeg_native(str(root / "data/jpeg_cases/pil_444_q75_37x23.jpg"))  # build and warm
    views = sorted(str(p) for p in (root / "data/colmap_flagship800_jpg/images").glob("*.jpg"))
    out = {"tree": str(Path(jpeg_ops.__file__).resolve().parents[2]), "views": len(views)}
    t0 = time.perf_counter()
    for p in views:
        jpeg_ops.read_jpeg_native(p)
    out["views_ms_per_mpx"] = 1e3 * (time.perf_counter() - t0) / (len(views) * VIEW_MPX)
    frames = {}
    for name in BIG:
        times = []
        try:
            for _ in range(3):
                t0 = time.perf_counter()
                jpeg_ops.read_jpeg_native(str(root / "data/jpeg_cases" / name))
                times.append(time.perf_counter() - t0)
        except ValueError:
            continue
        frames[name] = 1e3 * sorted(times)[1] / BIG_MPX
    out["frames_ms_per_mpx"] = frames
    return out


if __name__ == "__main__":
    print(json.dumps(main(Path(sys.argv[1]) if len(sys.argv) > 1 else Path(__file__).resolve().parents[2])))
