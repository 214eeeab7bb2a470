"""A COLMAP scene of JPEG images read by the port on the CPU (the plain
decoder) and by the JAX package (PIL): the same cameras, the decoded
images equal, and `load_cam`'s GTs equal bit for bit at `-r 1`, `-r 2` and
the 1,600-px rule (an image just over 1,600 px wide and a few rows high),
for 4:2:0, 4:4:4 and grayscale files."""

import os

import numpy as np
import pytest
import torch

from jpeg_fixtures import pil_bytes, sample_image
from sgs_tpu.data import camera_utils as jax_cu
from sgs_tpu.data import readers as jax_readers
from sgs_tpu_torch.data import camera_utils as cu
from sgs_tpu_torch.data import readers
from sgs_tpu_torch.tools.colmap_scene import pinhole, write_sparse
from test_torch_camera_utils import _compare

torch.set_num_threads(1)


def _scene(root, size, kinds):
    """A COLMAP scene of len(kinds) JPEGs of `size` (w, h) on a circle."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    w, h = size
    images = []
    for i, kind in enumerate(kinds):
        name = f"img_{i:02d}.jpg"
        img = sample_image(h, w, 10 + i, gray=kind == "gray")
        kw = {"quality": 90} if kind == "gray" else {"quality": 85 + i, "subsampling": kind}
        with open(os.path.join(root, "images", name), "wb") as f:
            f.write(pil_bytes(img, **kw))
        a = 0.4 * i
        w2c = np.eye(4)
        w2c[:3, :3] = [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]]
        w2c[:3, 3] = [0.1 * i, -0.2, 3.0]
        images.append((name, w2c))
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(30, 3))
    rgb = rng.integers(0, 256, (30, 3), dtype=np.uint8)
    write_sparse(root, pinhole(w, h, 0.9), images, xyz, rgb, binary=True)
    return root


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    base = tmp_path_factory.mktemp("jpeg_scene")
    small = _scene(str(base / "small"), (45, 31), ["4:2:0", "4:4:4", "gray", "4:2:2"])
    wide = _scene(str(base / "wide"), (1613, 7), ["4:2:0", "4:4:4"])
    return {"small": small, "wide": wide}


@pytest.mark.parametrize("which,resolution", [("small", 1), ("small", 2), ("wide", -1)])
def test_jpeg_colmap_scene_matches_jax(scenes, which, resolution, monkeypatch):
    monkeypatch.setattr(jax_cu, "_WARNED", True)
    monkeypatch.setitem(cu._warned, "large", True)
    want = jax_readers.read_colmap_scene(scenes[which], None, False)
    got = readers.read_colmap_scene(scenes[which], None, False, device="cpu")
    assert [c.image_name for c in got.train_cameras] == [c.image_name for c in want.train_cameras]
    for i, (w, g) in enumerate(zip(want.train_cameras, got.train_cameras)):
        ref = np.asarray(w.image)
        np.testing.assert_array_equal(g.image, ref[:, :, None] if ref.ndim == 2 else ref)
        np.testing.assert_allclose(g.R, w.R, rtol=0, atol=0)
        assert (g.FovX, g.FovY, g.width, g.height) == (w.FovX, w.FovY, w.width, w.height)
        loaded_want = jax_cu.load_cam(resolution, i, w, 1.0)
        loaded_got = cu.load_cam(resolution, i, g, 1.0, device="cpu")
        _compare(loaded_want, loaded_got)
        if which == "wide":
            assert loaded_got.camera.image_width == 1600


def test_scene_decodes_for_its_device(scenes, monkeypatch):
    """A scene loaded for the CPU decodes with the plain decoder; one loaded
    for the card goes to the native decoder (here it has no nvcc, so the
    build raises: there is no fallback to the plain version)."""
    from sgs_tpu_torch.ops import build, jpeg as native

    calls = []
    monkeypatch.setattr(readers, "read_jpeg", lambda p: calls.append(p) or np.zeros((31, 45, 3), np.uint8))
    readers.read_colmap_scene(scenes["small"], None, False, device="cpu")
    assert len(calls) == 4

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(native.DECODER, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        readers.read_colmap_scene(scenes["small"], None, False, device="cuda")
    assert len(calls) == 4


def test_smoke_tables_match_committed_run():
    """chip_smoke.py's per-view tables of the JAX package on the JPEG
    flagship are those of runs/colmap_flagship800_jpg_jax (its run.py)."""
    import json

    import chip_smoke

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    per_view = json.load(open(os.path.join(root, "runs", "colmap_flagship800_jpg_jax", "model_full",
                                           "per_view.json")))["ours_15000"]
    names = sorted(per_view["PSNR"])
    assert len(names) == 7
    assert chip_smoke.JAX_JPG_PSNR == [per_view["PSNR"][n] for n in names]
    assert chip_smoke.JAX_JPG_SSIM == [per_view["SSIM"][n] for n in names]
