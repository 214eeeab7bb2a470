"""Kernel E's variants on the 1080p scene, against Kernel A. Port of
`scripts/exp_fwd.py`.

    python -m sgs_tpu_torch.tools.exp_fwd [--width W --height H --n N --seed S --device cuda]

Builds the scene of `tools/exp_scene.py` (1920x1080, 100,000 Gaussians,
rect binning, rows of 64 instances), times Kernel A on its bins, then each
variant of Kernel E, (krows, mode) = (8, hs), (32, hs), (8, mxu), (32,
mxu), (32, nocp), in device ms (`tools/ssim_times.py::time_ms`; "not
measured" on the CPU), and prints each variant's max error against Kernel
A but nocp's (wrong math by design). The errors leave out the pixels where
a running product or an alpha lies at a cut (`exp_forward.near_cut`) and
give their count. Ends with the card's name and power limit.
"""

from __future__ import annotations

import sys

from sgs_tpu_torch.ops import exp_forward, flat_raster
from sgs_tpu_torch.tools import exp_scene

VARIANTS = [(8, "hs"), (32, "hs"), (8, "mxu"), (32, "mxu"), (32, "nocp")]


def err_line(err: dict) -> str:
    return (f"    max err vs Kernel A: color {err['color']:.2e} t_final {err['t_final']:.2e} "
            f"lastc {err['last_contrib']:.2e} ({err['near_cut_pixels']} pixels at a cut left out; "
            f"with them {err['color_all']:.2e} / {err['t_final_all']:.2e} / {err['last_contrib_all']:.2e})")


def run(sc: dict, dev, ref, near) -> list:
    """Time Kernel A and E's variants on the scene `sc` and hold each to
    Kernel A's tiles `ref` off the pixels `near` a cut
    (`exp_scene.references`)."""
    ms = exp_scene.device_ms(lambda: flat_raster.rasterize_tiles(*sc["kernel_a"]), dev)
    print(f"{'Kernel A (flat_raster.cu)':36s} {exp_scene.fmt_ms(ms)}", flush=True)
    results = [{"kernel": "A", "ms": ms}]
    args = (sc["packed_fm"], sc["chunk_row_start"], sc["n_chunks"], sc["schedule"], sc["tiles_x"])
    for krows, mode in VARIANTS:
        fn = lambda: exp_forward.exp_forward(*args, mode, krows)
        ms = exp_scene.device_ms(fn, dev)
        row = {"kernel": "E", "krows": krows, "mode": mode, "ms": ms}
        print(f"{f'E krows={krows} mode={mode}':36s} {exp_scene.fmt_ms(ms)}", flush=True)
        if mode != "nocp":
            out = fn()
            row["err"] = exp_scene.compare_with_a(sc, ref, out[:, :, 0:3].transpose(1, 2),
                                                  out[:, :, 4], out[:, :, 5], near)
            print(err_line(row["err"]), flush=True)
        results.append(row)
    print(exp_scene.card_line(), flush=True)
    return results


def main(argv=None) -> list:
    dev, sc = exp_scene.cli_scene("Kernel E's variants against Kernel A", argv)
    return run(sc, dev, *exp_scene.references(sc))


if __name__ == "__main__":
    main(sys.argv[1:])
