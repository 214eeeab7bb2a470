"""The port's ray-traced dataset (`sgs_tpu_torch.utils.raytrace_scene`)
on the CPU: JAX's images bit for bit and its JSON and `points3d.ply`
bytes at a small size, and the checks of tests/test_raytrace_scene.py
(`:26`, `:39`, `:51`) on the port: the loader round trip, distinct views,
and a short training run (here through the port's trainer on the CPU)
that lowers the test L1."""

import glob
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sgs_tpu.utils import raytrace_scene as jax_rt
from sgs_tpu_torch.data.png import read_png
from sgs_tpu_torch.data.readers import read_nerf_synthetic_scene
from sgs_tpu_torch.utils.raytrace_scene import make_raytraced_dataset

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def rt_dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("rtscene"))
    make_raytraced_dataset(out, n_train=6, n_test=2, width=64, height=64, n_init_points=500)
    return out


def test_matches_jax_bit_for_bit(tmp_path):
    kw = dict(n_train=3, n_test=2, width=48, height=36, n_init_points=200, seed=1)
    jax_rt.make_raytraced_dataset(str(tmp_path / "jax"), **kw)
    make_raytraced_dataset(str(tmp_path / "port"), **kw)
    for name in ("transforms_train.json", "transforms_test.json", "points3d.ply"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    want = sorted(glob.glob(str(tmp_path / "jax" / "*" / "*.png")))
    assert len(want) == 5
    for w in want:
        g = w.replace(os.sep + "jax" + os.sep, os.sep + "port" + os.sep)
        np.testing.assert_array_equal(read_png(g), np.asarray(Image.open(w)), err_msg=w)


def test_raytraced_loader_roundtrip(rt_dataset):
    info = read_nerf_synthetic_scene(rt_dataset, False, True, device="cpu")
    assert len(info.train_cameras) == 6
    assert len(info.test_cameras) == 2
    # the init cloud is the surface-sample ply, not a random one
    assert info.point_cloud.points.shape[0] == 500
    # images are textured: nontrivial variance within each view
    assert (info.train_cameras[0].image / 255.0).std() > 0.05


def test_raytraced_views_consistent(rt_dataset):
    """Different views see the same scene (not degenerate copies)."""
    info = read_nerf_synthetic_scene(rt_dataset, False, True, device="cpu")
    a = info.train_cameras[0].image / 255.0
    b = info.train_cameras[3].image / 255.0
    assert a.shape == b.shape
    assert np.abs(a - b).mean() > 0.01  # genuinely different viewpoints


def test_short_train_reduces_loss(rt_dataset, tmp_path):
    from sgs_tpu_torch.train.trainer import training
    from sgs_tpu_torch.utils.config import ModelParams, OptimizationParams, PipelineParams

    model_path = str(tmp_path / "model")
    dataset = ModelParams(source_path=rt_dataset, model_path=model_path, eval=True)
    opt = OptimizationParams(iterations=120, densify_from_iter=1_000_000, position_lr_max_steps=120)
    training(dataset, opt, PipelineParams(no_tqdm=True), [1, 120], [120], [], None, device="cpu")
    rows = [ln.split("\t") for ln in open(os.path.join(model_path, "losses.tsv")).read().strip().splitlines()[1:]]
    assert len(rows) == 2
    first, last = float(rows[0][1]), float(rows[-1][1])
    assert last < first * 0.8, (first, last)
