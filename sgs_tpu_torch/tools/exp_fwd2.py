"""Kernel F's structural ablations on the 1080p scene. Port of
`scripts/exp_fwd2.py`.

    python -m sgs_tpu_torch.tools.exp_fwd2 [--width W --height H --n N --seed S --device cuda]

Times, in device ms, (mode, krows, out_cols) = (empty, 8, 8), (outonly,
8, 8), (alpha, 8, 8), (alpha, 8, 1), (alpha, 32, 1) on the scene of
`tools/exp_scene.py`, beside Kernel A and Kernel E (8, hs) on the same
rows: what a launch over the grid costs, what writing the per-row state
adds, and what evaluating alpha adds. Ends with the card's name and power
limit.
"""

from __future__ import annotations

import sys

from sgs_tpu_torch.ops import exp_forward, flat_raster
from sgs_tpu_torch.tools import exp_scene

ABLATIONS = [("empty", 8, 8), ("outonly", 8, 8), ("alpha", 8, 8), ("alpha", 8, 1), ("alpha", 32, 1)]


def run(sc: dict, dev) -> list:
    """Time Kernel A, E (8, hs) and F's ablations on the scene `sc`."""
    args = (sc["packed_fm"], sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"])
    results = []
    for name, fn in (("Kernel A", lambda: flat_raster.rasterize_tiles(*sc["kernel_a"])),
                     ("E krows=8 mode=hs", lambda: exp_forward.exp_forward(*args, "hs", 8))):
        ms = exp_scene.device_ms(fn, dev)
        results.append({"kernel": name.split()[0], "ms": ms})
        print(f"{name:36s} {exp_scene.fmt_ms(ms)}", flush=True)
    for mode, krows, oc in ABLATIONS:
        ms = exp_scene.device_ms(lambda: exp_forward.exp_ablation(*args, mode, krows, oc), dev)
        results.append({"kernel": "F", "mode": mode, "krows": krows, "out_cols": oc, "ms": ms})
        print(f"{f'F {mode} krows={krows} out_cols={oc}':36s} {exp_scene.fmt_ms(ms)}", flush=True)
    print(exp_scene.card_line(), flush=True)
    return results


def main(argv=None) -> list:
    dev, sc = exp_scene.cli_scene("Kernel F's ablations", argv)
    return run(sc, dev)


if __name__ == "__main__":
    main(sys.argv[1:])
