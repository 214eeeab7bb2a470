"""The tiled rasterizer without tight culling (`--no-tight_culling`): every
visible Gaussian is binned into each tile of its 3-sigma rect, as JAX's
rect binning does.

The rect-binned image and gradients (binning, Kernel A's and Kernel C's
plain versions) against JAX's rect path (`rasterize_tiled` with no row
bucket: the Pallas kernels in interpret mode, and the scan compositor of
the xla route), at the image bar 3e-5 and tests/test_torch_raster_backward.py's
gradient bars; and against the port's tight path: the image and t_final
bit for bit (the instances tight culling drops composite nothing), the gradients within the same bars (Kernel C sums each
Gaussian's run of instances in an order set by the run's length, and the
dropped instances' zeros lengthen the runs). Then the train, render, view
and train_lgm CLIs with `--no-tight_culling` on small scenes against the
same CLIs with tight culling."""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sgs_tpu.render.tiled import instance_count, rasterize_tiled
from sgs_tpu_torch.render import tiled
from sgs_tpu_torch.utils import config
from test_torch_raster import _scene, _torch
from test_torch_raster_backward import ATOL_SCALE, FIELDS, RTOL, _cotangent

torch.set_num_threads(1)
ATOL = 3e-5
REPORT = re.compile(r"L1 (\S+) PSNR (\S+)")


def _jax_rect(sc, ct, w, h, backend):
    """JAX's rect-binned image and the gradients of sum(image * ct)."""
    j = {k: jnp.asarray(v) for k, v in sc.items()}
    n_inst = int(instance_count(j["mean2d"], j["radius"], j["valid"], w, h))
    cap = -(-n_inst // 1024) * 1024 + 1024

    def image(m2, cn, rg, op, bg):
        img, ovf = rasterize_tiled(m2, j["depth"], cn, rg, op, j["radius"], j["valid"], bg, w, h,
                                   max_instances=cap, backend=backend)
        return img, ovf

    img, ovf = image(*(j[k] for k in FIELDS))
    assert int(ovf) == 0
    grads = jax.grad(lambda *a: jnp.sum(image(*a)[0] * ct), argnums=tuple(range(5)))(
        *(j[k] for k in FIELDS))
    return np.asarray(img), [np.asarray(g) for g in grads], n_inst


def _port(sc, ct, w, h, tight):
    t = _torch(sc)
    leaves = [t[k].clone().requires_grad_(True) for k in FIELDS]
    m2, cn, rg, op, bg = leaves
    img, aux = tiled.rasterize_tiled(m2, t["depth"], cn, rg, op, t["radius"], t["valid"], bg, w, h,
                                     tight=tight)
    (img * torch.from_numpy(ct)).sum().backward()
    return img.detach().numpy(), [x.grad.numpy() for x in leaves], aux


@pytest.mark.parametrize("backend", ["pallas", "xla"])
@pytest.mark.parametrize("w,h,seed", [(64, 48, 0), (70, 33, 1)])
def test_rect_binning_matches_jax(w, h, seed, backend):
    sc = _scene(seed, 300, w, h)
    ct = _cotangent(seed + 10, w, h)
    img, grads, aux = _port(sc, ct, w, h, tight=False)
    want_img, want_grads, n_inst = _jax_rect(sc, ct, w, h, backend)
    assert aux["n_instances"] == n_inst
    np.testing.assert_allclose(img, want_img, atol=ATOL, rtol=0)
    for name, g, wv in zip(FIELDS, grads, want_grads):
        assert np.abs(wv).max() > 0, name
        np.testing.assert_allclose(g, wv, rtol=RTOL, atol=ATOL_SCALE * np.abs(wv).max(),
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("w,h,seed", [(64, 48, 0), (70, 33, 1), (96, 80, 2)])
def test_rect_binning_equals_tight(w, h, seed):
    sc = _scene(seed, 400, w, h)
    ct = _cotangent(seed + 20, w, h)
    img_r, grads_r, aux_r = _port(sc, ct, w, h, tight=False)
    img_t, grads_t, aux_t = _port(sc, ct, w, h, tight=True)
    assert 0 < aux_t["n_instances"] < aux_r["n_instances"]
    np.testing.assert_array_equal(img_r, img_t)
    np.testing.assert_array_equal(aux_r["t_final"].numpy(), aux_t["t_final"].numpy())
    for name, g_r, g_t in zip(FIELDS, grads_r, grads_t):
        np.testing.assert_allclose(g_r, g_t, rtol=RTOL, atol=ATOL_SCALE * np.abs(g_t).max(),
                                   err_msg=name)


@pytest.mark.parametrize("tight,mode", [(True, "tiled"), (False, "rect")])
def test_check_rasterizer_modes(tight, mode):
    assert config.check_rasterizer(config.PipelineParams(tight_culling=tight)) == mode
    assert config.check_rasterizer(config.PipelineParams(rasterizer="reference",
                                                         tight_culling=tight)) == "reference"
    with pytest.raises(NotImplementedError, match="unknown rasterizer"):
        config.check_rasterizer(config.PipelineParams(rasterizer="xla", tight_culling=tight))


@pytest.fixture(scope="module")
def toy_scene(tmp_path_factory):
    from sgs_tpu.utils.toy_scene import make_blender_dataset
    from sgs_tpu_torch.data.ply import save_point_cloud_ply

    out = str(tmp_path_factory.mktemp("toyscene"))
    make_blender_dataset(out, n_train=6, n_test=2, width=32, height=32, n_gaussians=60, seed=4)
    rng = np.random.default_rng(2)
    save_point_cloud_ply(f"{out}/points3d.ply", (rng.random((300, 3)) * 2 - 1).astype(np.float32),
                         rng.integers(0, 256, (300, 3)).astype(np.uint8))
    return out


def _train(scene, model, tight):
    from sgs_tpu_torch.train.__main__ import main

    argv = ["-s", scene, "-m", str(model), "--eval", "--device", "cpu", "--quiet",
            "--iterations", "30", "--densify_from_iter", "5", "--densification_interval", "10",
            "--densify_until_iter", "25", "--test_iterations", "15", "30",
            "--save_iterations", "30", "--checkpoint_iterations", "30"]
    main(argv + ([] if tight else ["--no-tight_culling"]))
    return np.load(os.path.join(str(model), "chkpnt30.npz"))


def _rows(path):
    return np.loadtxt(path, skiprows=1, ndmin=2)


def test_train_cli_without_tight_culling(toy_scene, tmp_path):
    """30 iterations with two densify steps: the losses.tsv rows to rtol
    1e-5 with the same Gaussian counts, and the checkpoint's fields within
    tests/test_torch_train_step.py's bars with the same alive slots, as
    with tight culling (the runs differ only in the gradients' rounding)."""
    rect = _train(toy_scene, tmp_path / "rect", tight=False)
    tight = _train(toy_scene, tmp_path / "tight", tight=True)
    rows_r, rows_t = _rows(tmp_path / "rect" / "losses.tsv"), _rows(tmp_path / "tight" / "losses.tsv")
    assert rows_r.shape == rows_t.shape == (2, 4)
    np.testing.assert_array_equal(rows_r[:, [0, 3]], rows_t[:, [0, 3]])
    np.testing.assert_allclose(rows_r, rows_t, rtol=1e-5)
    assert sorted(rect.files) == sorted(tight.files)
    np.testing.assert_array_equal(rect["alive"], tight["alive"])
    for k in rect.files:
        want = tight[k].astype(np.float64)
        np.testing.assert_allclose(rect[k], want, rtol=1e-4, atol=2e-4 * np.abs(want).max(),
                                   err_msg=k)


def test_render_and_view_cli_without_tight_culling(toy_scene, tmp_path):
    from sgs_tpu_torch.data.png import read_png
    from sgs_tpu_torch.render.cli import main as render_main
    from sgs_tpu_torch.view import main as view_main

    model = tmp_path / "model"
    _train(toy_scene, model, tight=True)
    out = {}
    for flag in ([], ["--no-tight_culling"]):
        render_main(["-m", str(model), "--device", "cpu", "--quiet", *flag])
        view_main(["-m", str(model), "--frames", "2", "--width", "40", "--image_height", "32",
                   "--out", str(tmp_path / f"orbit{len(flag)}"), "--device", "cpu", *flag])
        pngs = sorted(model.glob("*/ours_30/renders/*.png")) + sorted(
            (tmp_path / f"orbit{len(flag)}").glob("frame_*.png"))
        out[len(flag)] = [read_png(str(p)) for p in pngs]
    assert len(out[0]) == len(out[1]) == 6 + 2 + 2
    for a, b in zip(out[0], out[1]):
        np.testing.assert_array_equal(a, b)


def test_train_lgm_cli_without_tight_culling(toy_scene, tmp_path, capsys):
    """20 iterations: the report's L1 and PSNR to rtol 1e-5 of the tight run's."""
    from sgs_tpu_torch.train_lgm import main as train_lgm_main

    reports = {}
    for flag in ([], ["--no-tight_culling"]):
        model = tmp_path / f"lgm{len(flag)}"
        train_lgm_main(["-s", toy_scene, "-m", str(model), "--eval", "--device", "cpu",
                        "--iterations", "20", "--downsample_init", "10", "--test_iterations", "20",
                        *flag])
        reports[len(flag)] = [[float(x) for x in REPORT.findall(ln)[0]]
                              for ln in capsys.readouterr().out.splitlines() if "] Evaluating" in ln]
    assert len(reports[0]) == len(reports[1]) == 2
    np.testing.assert_allclose(reports[1], reports[0], rtol=1e-5)
