"""Kernel G (instance-major rows, state written pixels-minor) on the
1080p scene, against Kernel A. Port of `scripts/exp_transposed.py`.

    python -m sgs_tpu_torch.tools.exp_transposed [--width W --height H --n N --seed S --device cuda]

Reads `rows.pack_rows`' (R*64, 16) rows as they are. Times Kernel A and
G's hs and mxu (krows 8) in device ms and prints G's max error against
Kernel A on every tile (G masks empty tiles itself), leaving out the
pixels at a cut (`exp_forward.near_cut`). Ends with the card's name and
power limit.
"""

from __future__ import annotations

import sys

from sgs_tpu_torch.ops import exp_forward, flat_raster
from sgs_tpu_torch.tools import exp_scene
from sgs_tpu_torch.tools.exp_fwd import err_line

VARIANTS = [("hs", 8), ("mxu", 8)]


def run(sc: dict, dev, ref, near) -> list:
    """Time Kernel A and G on the scene `sc` and hold G to Kernel A's
    tiles `ref` off the pixels `near` a cut (`exp_scene.references`)."""
    ms = exp_scene.device_ms(lambda: flat_raster.rasterize_tiles(*sc["kernel_a"]), dev)
    print(f"{'Kernel A (flat_raster.cu)':36s} {exp_scene.fmt_ms(ms)}", flush=True)
    results = [{"kernel": "A", "ms": ms}]
    args = (sc["packed"], sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"])
    for mode, krows in VARIANTS:
        fn = lambda: exp_forward.exp_transposed(*args, mode, krows)
        ms = exp_scene.device_ms(fn, dev)
        print(f"{f'G mode={mode} krows={krows}':36s} {exp_scene.fmt_ms(ms)}", flush=True)
        c, t, lc = fn()
        err = exp_scene.compare_with_a(sc, ref, c, t, lc, near)
        print(err_line(err), flush=True)
        results.append({"kernel": "G", "mode": mode, "krows": krows, "ms": ms, "err": err})
    print(exp_scene.card_line(), flush=True)
    return results


def main(argv=None) -> list:
    dev, sc = exp_scene.cli_scene("Kernel G against Kernel A", argv)
    return run(sc, dev, *exp_scene.references(sc))


if __name__ == "__main__":
    main(sys.argv[1:])
