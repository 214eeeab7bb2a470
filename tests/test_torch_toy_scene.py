"""The port's synthetic scenes (`sgs_tpu_torch.utils.toy_scene`) against
the JAX package's on the CPU: the same GT Gaussians from the same seed
(both samplers), the same poses and cameras, and Blender and COLMAP
datasets with the same JSON, the same COLMAP bytes and the same pixels
(the GT rendered by each package's oracle)."""

import glob
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sgs_tpu.utils import toy_scene as jax_toy
from sgs_tpu_torch.data.png import read_png
from sgs_tpu_torch.utils import toy_scene

torch.set_num_threads(1)


@pytest.mark.parametrize("sampler,n", [("sample_gt_gaussians", 300), ("sample_gt_gaussians_hard", 500)])
def test_samplers_match_jax(sampler, n):
    want = getattr(jax_toy, sampler)(n, 3)
    got = getattr(toy_scene, sampler)(n, 3)
    assert want.keys() == got.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_cameras_match_jax():
    c2w = toy_scene.circle_pose(0.8, radius=2.5, height=0.3)
    np.testing.assert_array_equal(c2w, jax_toy.circle_pose(0.8, radius=2.5, height=0.3))
    got = toy_scene.camera_from_c2w(c2w, math.radians(50), 40, 30, "cpu")
    want = jax_toy.camera_from_c2w(c2w, math.radians(50), 40, 30)
    for key in ("world_view_transform", "full_proj_transform", "camera_center", "tanfovx", "tanfovy"):
        np.testing.assert_array_equal(getattr(got, key).numpy(), np.asarray(getattr(want, key)), err_msg=key)


def _pixels(paths):
    return [np.asarray(Image.open(p)) for p in paths]


def test_blender_dataset_matches_jax(tmp_path):
    kw = dict(n_train=3, n_test=2, width=24, height=20, n_gaussians=120, seed=1)
    jax_toy.make_blender_dataset(str(tmp_path / "jax"), **kw)
    toy_scene.make_blender_dataset(str(tmp_path / "port"), device="cpu", **kw)
    for split in ("train", "test"):
        name = f"transforms_{split}.json"
        assert (tmp_path / "port" / name).read_text() == (tmp_path / "jax" / name).read_text()
    want = sorted(glob.glob(str(tmp_path / "jax" / "*" / "*.png")))
    got = [p.replace(os.sep + "jax" + os.sep, os.sep + "port" + os.sep) for p in want]
    assert len(want) == 5
    for w, g in zip(want, got):
        np.testing.assert_array_equal(read_png(g), np.asarray(Image.open(w)), err_msg=w)


def test_colmap_dataset_matches_jax(tmp_path):
    kw = dict(n_views=3, width=24, height=20, n_gaussians=120, n_points=50, seed=2)
    jax_toy.make_colmap_dataset(str(tmp_path / "jax"), **kw)
    toy_scene.make_colmap_dataset(str(tmp_path / "port"), device="cpu", **kw)
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        rel = os.path.join("sparse", "0", name)
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), name
    for i in range(3):
        rel = os.path.join("images", f"img_{i:03d}.png")
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / rel)),
                                      np.asarray(Image.open(str(tmp_path / "jax" / rel))))
