"""The port's get_psnr (`python -m sgs_tpu_torch.get_psnr`) against the
repository's get_psnr.py on the CPU.

Mirrors tests/test_eval_tools.py::test_get_psnr_cli_with_checkpoint and
::test_get_psnr_cli_with_vectorized. A toy Blender scene written by the
JAX package (`make_blender_dataset`, 6 train and 2 test views at 32x32,
with a small points3d.ply so neither Scene draws 100,000 random points)
and a JAX pool of its Gaussians (SH degree 3, seeded higher bands, dead
slots) saved with JAX's `save_checkpoint`; the `.npy` route takes the
array JAX's `vectorized` writes. On both routes the port's losses.tsv
(header, iteration, L1, PSNR, count) and its printed train line (every
train view, as `full_train_set` asks) match JAX's: L1 within rtol 1e-5,
PSNR within 1e-4 dB. Both render with the oracle (the default mode of
`training_report`).

`chip_smoke.py` phase 12 holds the port on the card to the JAX run on
the committed LGM snapshot; its constants must equal that run's files
(runs/get_psnr_lgm400_jax/).
"""

import os
import re

import numpy as np
import pytest
import torch

import get_psnr as jax_get_psnr
from sgs_tpu.data.scene import pool_from_arrays
from sgs_tpu.models.gaussians import DensifyStats
from sgs_tpu.models.vectorized import vectorized
from sgs_tpu.train.checkpoint import save_checkpoint
from sgs_tpu.train.loop import TrainState
from sgs_tpu.train.optim import AdamState
from sgs_tpu.utils.toy_scene import make_blender_dataset
from sgs_tpu_torch import get_psnr
from sgs_tpu_torch.data.ply import save_point_cloud_ply

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = re.compile(r"\[ITER (\d+)\] Evaluating (\w+): L1 (\S+) PSNR (\S+)")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("get_psnr")
    src = str(root / "scene")
    gt = make_blender_dataset(src, n_train=6, n_test=2, width=32, height=32, n_gaussians=120, seed=5)
    n = gt["means3d"].shape[0]
    save_point_cloud_ply(os.path.join(src, "points3d.ply"), gt["means3d"][:60],
                         (gt["colors"][:60] * 255).astype(np.uint8))
    rng = np.random.default_rng(6)
    arrays = {
        "xyz": gt["means3d"],
        "features_dc": ((gt["colors"] - 0.5) / 0.28209479177387814)[:, None, :].astype(np.float32),
        "features_rest": rng.normal(0, 0.05, (n, 15, 3)).astype(np.float32),
        "scaling": np.log(gt["scales"]).astype(np.float32),
        "rotation": gt["rotations"],
        "opacity": np.log(gt["opacity"] / (1 - gt["opacity"])).astype(np.float32),
    }
    pool = pool_from_arrays(arrays, 3)
    npz = str(root / "chkpnt30.npz")
    save_checkpoint(npz, TrainState(pool=pool, adam=AdamState.init(pool.params()),
                                    stats=DensifyStats.zeros(pool.capacity)), 30, 3, 1.0)
    vec = str(root / "vec.npy")
    np.save(vec, np.concatenate(vectorized(pool), axis=1))
    return src, {"npz": npz, "npy": vec}


def _run(main, argv, out_dir, capsys):
    main(argv)
    printed = capsys.readouterr().out
    lines = {m.group(2): m.groups() for m in LINE.finditer(printed)}
    with open(os.path.join(out_dir, "losses.tsv")) as f:
        return f.read().splitlines(), lines


@pytest.mark.parametrize("route", ["npz", "npy"])
def test_matches_jax_get_psnr(inputs, route, tmp_path, capsys):
    src, ckpt = inputs
    argv = ["-s", src, "-w", "--eval", "--start_checkpoint", ckpt[route]]
    want_tsv, want = _run(jax_get_psnr.main, argv + ["-m", str(tmp_path / "jax")], tmp_path / "jax", capsys)
    got_tsv, got = _run(get_psnr.main, argv + ["-m", str(tmp_path / "port"), "--device", "cpu"],
                        tmp_path / "port", capsys)
    assert got_tsv[0] == want_tsv[0] == "iteration\ttest_l1\ttest_psnr\tnum_gaussians"
    assert len(got_tsv) == len(want_tsv) == 2
    g, w = got_tsv[1].split("\t"), want_tsv[1].split("\t")
    assert (g[0], g[3]) == (w[0], w[3]) == ("30" if route == "npz" else "0", "120")
    np.testing.assert_allclose(float(g[1]), float(w[1]), rtol=1e-5)
    np.testing.assert_allclose(float(g[2]), float(w[2]), atol=1e-4, rtol=0)
    assert sorted(got) == sorted(want) == ["test", "train"]
    for name in ("test", "train"):
        assert got[name][0] == want[name][0]
        np.testing.assert_allclose(float(got[name][2]), float(want[name][2]), rtol=1e-5)
        np.testing.assert_allclose(float(got[name][3]), float(want[name][3]), atol=1e-4, rtol=0)
    assert float(got["train"][3]) > 10.0


def test_quiet_and_default_model_path(inputs, tmp_path, monkeypatch, capsys):
    src, ckpt = inputs
    monkeypatch.chdir(tmp_path)
    get_psnr.main(["-s", src, "-w", "--eval", "--quiet", "--start_checkpoint", ckpt["npz"],
                   "--device", "cpu"])
    assert capsys.readouterr().out == ""
    assert (tmp_path / "output" / "get_psnr" / "losses.tsv").exists()


def test_chip_smoke_holds_the_committed_jax_run():
    """chip_smoke.py's phase-12 constants are the committed JAX run's:
    the test row of each route's losses.tsv and the train line of its log."""
    import chip_smoke

    run_dir = os.path.join(ROOT, "runs", "get_psnr_lgm400_jax")
    log = open(os.path.join(run_dir, "run.log")).read()
    trains = [tuple(float(v) for v in m.groups()[2:]) for m in LINE.finditer(log) if m.group(2) == "train"]
    assert len(trains) == 2
    for route, train in zip(("vec", "npz"), trains):
        row = open(os.path.join(run_dir, route, "losses.tsv")).read().splitlines()[1].split("\t")
        want = {"iteration": int(row[0]), "test": (float(row[1]), float(row[2])), "train": train,
                "count": int(row[3])}
        assert chip_smoke.JAX_GET_PSNR[route] == want, route


def test_colmap_copy_from_decoded_images(inputs, tmp_path):
    """`blender_to_colmap(..., composited=...)` (chip_smoke.py phase 11
    hands it the images it decoded for the Blender form) writes the same
    bytes as decoding the scene's PNGs itself."""
    from sgs_tpu_torch.data.readers import read_cameras_from_transforms
    from sgs_tpu_torch.tools.colmap_scene import blender_to_colmap

    src, _ = inputs
    composited = {f"{split}_{info.image_name}": info.image for split in ("train", "test")
                  for info in read_cameras_from_transforms(src, f"transforms_{split}.json", False)}
    assert blender_to_colmap(src, str(tmp_path / "a")) == 8
    assert blender_to_colmap(src, str(tmp_path / "b"), composited=composited) == 8
    files = sorted(p.relative_to(tmp_path / "a") for p in (tmp_path / "a").rglob("*") if p.is_file())
    assert len(files) == 8 + 3
    for f in files:
        assert (tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes(), f
