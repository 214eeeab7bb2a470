"""Gaussian parameter analysis. Port of the repository's `analyze_model.py`.

    python -m sgs_tpu_torch.analyze_model --ply <point_cloud.ply> [--out my_tests]
        [--sh_degree 3] [--rank 3]

The flags and defaults are `analyze_model.py`'s. It loads the PLY, checks
the vectorize round trip (`models/vectorized.py`, the same two
`np.allclose` assertions), writes the opacity histograms (20 bins, plain
and cumulative) and the appearance-PCA variance-explained curves,
unnormalised and normalised (plain and cumulative), as SVG
(`utils/svg_plot.py`, the plotted data in each file), and the rank-`rank`
PCA reconstructions as PLYs in `<out>_ply_unnorm/` and `<out>_ply_normal/`.
It prints `analyze_model.py`'s lines with the same numbers. The model is
held on --device (the card unless the caller asks for the CPU); the
analysis is numpy on the host.
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import numpy as np


def build_parser() -> ArgumentParser:
    parser = ArgumentParser(description="Gaussian model analysis (PyTorch/CUDA port)")
    parser.add_argument("--ply", required=True)
    parser.add_argument("--out", default="my_tests")
    parser.add_argument("--sh_degree", type=int, default=3)
    parser.add_argument("--rank", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    return parser


def main(argv=None) -> None:
    from sgs_tpu_torch.core.device import resolve_device
    from sgs_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply
    from sgs_tpu_torch.models.gaussians import from_jax_arrays
    from sgs_tpu_torch.models.vectorized import compute_normalization, from_vector, pca_project, vectorized
    from sgs_tpu_torch.utils.svg_plot import curve_svg, histogram_svg

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)
    arrays = load_gaussian_ply(args.ply, args.sh_degree)
    pool = from_jax_arrays(arrays, args.sh_degree, dev)
    shape_p, app_p = vectorized(pool)

    # round-trip check (the reference's allclose assertion)
    shape_p2, app_p2 = vectorized(from_vector(args.sh_degree, shape_p, app_p, device=dev))
    assert np.allclose(shape_p, shape_p2, rtol=1e-3, atol=1e-4)
    assert np.allclose(app_p, app_p2, rtol=1e-4, atol=1e-5)
    print(f"vectorize round trip OK ({shape_p.shape}, {app_p.shape})")

    opac = shape_p[:, 3]
    for cumulative, name in ((False, "opacities_hist"), (True, "opacities_hist_cumulative")):
        histogram_svg(os.path.join(args.out, f"{name}.svg"), opac, bins=20, cumulative=cumulative,
                      xlabel="Opacity",
                      ylabel="Number of components" + (" (cumulative)" if cumulative else ""))

    mean, std = compute_normalization(app_p)
    for use_std, tag in ((None, "unnormalized"), (std, "normalized")):
        recon, ratio = pca_project(app_p, args.rank, mean=mean, std=use_std)
        xs = np.arange(len(ratio)) + 1
        title = f"PCA of {tag} appearance (SH) parameters"
        curve_svg(os.path.join(args.out, f"appearance_{tag}_PCA_variance_explained.svg"), xs, ratio,
                  title, "# of PCA dimensions", "Ratio of variance explained")
        curve_svg(os.path.join(args.out, f"appearance_{tag}_PCA_variance_explained_cumulative.svg"), xs,
                  np.cumsum(ratio), title, "# of PCA dimensions",
                  "Ratio of variance explained (cumulative)")

        out_arrays = from_vector(args.sh_degree, shape_p, recon, device=dev).compact_arrays()
        save_gaussian_ply(
            os.path.join(args.out + f"_ply_{tag[:6]}", "point_cloud.ply"),
            out_arrays["xyz"], out_arrays["features_dc"], out_arrays["features_rest"],
            out_arrays["opacity"], out_arrays["scaling"], out_arrays["rotation"],
        )
        print(f"{tag}: top-{args.rank} PCA explains {np.cumsum(ratio)[args.rank - 1]:.3f}")
    print("Done.")


if __name__ == "__main__":
    main(sys.argv[1:])
