"""`python -m sgs_tpu_torch.analyze_model` on the CPU against the
repository's `analyze_model.py` (tests/test_viewer_and_tools.py:109): the
same files, the same printed lines (the PCA fractions to the printed
digit), plots that carry `np.histogram`'s 20 bins and the PCA variance
ratios, and PCA PLYs equal to JAX's that reload."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from sgs_tpu_torch.data.ply import load_gaussian_ply
from sgs_tpu_torch.utils.svg_plot import read_plot_data
from test_torch_view_cli import write_tiny_model

torch.set_num_threads(1)


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.mark.parametrize("rank", [2, 3])
def test_analyze_cli_matches_jax(tmp_path, rank):
    import analyze_model as jax_analyze
    from sgs_tpu_torch.analyze_model import main

    _, ply = write_tiny_model(tmp_path)
    port_out, jax_out = str(tmp_path / "port"), str(tmp_path / "jax")
    printed = _run(main, ["--ply", ply, "--out", port_out, "--rank", str(rank), "--device", "cpu"])
    jax_printed = _run(jax_analyze.main, ["--ply", ply, "--out", jax_out, "--rank", str(rank)])
    assert printed == jax_printed
    assert f"top-{rank} PCA explains" in printed
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out))
    for tag in ("unnorm", "normal"):
        a = load_gaussian_ply(os.path.join(port_out + f"_ply_{tag}", "point_cloud.ply"), 3)
        b = load_gaussian_ply(os.path.join(jax_out + f"_ply_{tag}", "point_cloud.ply"), 3)
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{tag} {key}")

    hist = read_plot_data(os.path.join(port_out, "opacities_hist.svg"))
    cum = read_plot_data(os.path.join(port_out, "opacities_hist_cumulative.svg"))
    opac = load_gaussian_ply(ply, 3)["opacity"][:, 0]
    counts, edges = np.histogram(1.0 / (1.0 + np.exp(-opac)), bins=20)
    assert hist["counts"] == counts.tolist() and cum["counts"] == np.cumsum(counts).tolist()
    np.testing.assert_allclose(hist["edges"], edges, rtol=1e-6)
    curve = read_plot_data(os.path.join(port_out, "appearance_normalized_PCA_variance_explained.svg"))
    assert curve["x"] == list(range(1, len(curve["x"]) + 1))
    assert abs(sum(curve["y"]) - 1.0) < 1e-5
