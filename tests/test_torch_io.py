"""Port parity of the I/O (sgs_tpu_torch.data): the PLY reader against
sgs_tpu.data.ply, the PNG codec against PIL, the Blender reader's GT images
against the JAX reader plus camera_utils, and the cameras against the JAX
Camera. Bytes and images bit-equal; matrices to atol 1e-6."""

import glob
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from sgs_tpu.data import camera_utils, readers
from sgs_tpu.data.ply import load_gaussian_ply as jax_load_gaussian_ply
from sgs_tpu_torch.data import camera_utils as port_camera_utils
from sgs_tpu_torch.data import png
from sgs_tpu_torch.data import readers as port_readers
from sgs_tpu_torch.data.ply import load_gaussian_ply

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_PNGS = sorted(glob.glob(os.path.join(ROOT, "data", "flagship800", "test", "*.png")))


@pytest.mark.parametrize("path,degree", [
    ("assets/flagship/point_cloud.ply", 3),
    ("assets/lgm/point_cloud.ply", 0),
])
def test_ply_bit_equal(path, degree):
    want = jax_load_gaussian_ply(os.path.join(ROOT, path), degree)
    got = load_gaussian_ply(os.path.join(ROOT, path), degree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ply_wrong_degree_raises():
    with pytest.raises(ValueError):
        load_gaussian_ply(os.path.join(ROOT, "assets/lgm/point_cloud.ply"), 3)


@pytest.mark.parametrize("path", FLAGSHIP_PNGS, ids=os.path.basename)
def test_png_matches_pil(path):
    np.testing.assert_array_equal(png.read_png(path), np.asarray(Image.open(path)))


def _encode(image: np.ndarray, filters) -> bytes:
    """A PNG with the given filter type on each row (reference encoder)."""
    h, w, c = image.shape
    bpp, stride = c, w * c
    rows = image.reshape(h, stride).astype(np.int32)
    out = []
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        f = filters[y % len(filters)]
        cur = rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_all_filters_and_modes(tmp_path, channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 17, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_encode(img, [0, 1, 2, 3, 4]))
    got = png.read_png(str(path))
    np.testing.assert_array_equal(got, img)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(got, pil.reshape(got.shape))


def test_png_write_round_trip(tmp_path):
    img = np.random.default_rng(0).integers(0, 256, (31, 45, 3), dtype=np.uint8)
    png.write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), img)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "w.png")), img)


def test_png_unsupported_raises(tmp_path):
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(tmp_path / "d16.png")
    with pytest.raises(ValueError):
        png.read_png(str(tmp_path / "d16.png"))


def _compare_scene(path, split, white):
    want = readers.read_cameras_from_transforms(path, f"transforms_{split}.json", white)
    got = port_readers.read_cameras_from_transforms(path, f"transforms_{split}.json", white)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.width, g.height, g.image_name) == (w.width, w.height, w.image_name)
        assert g.FovX == w.FovX and g.FovY == w.FovY
        np.testing.assert_array_equal(g.R, w.R)
        np.testing.assert_array_equal(g.T, w.T)
        lc_w = camera_utils.load_cam(-1, 0, w, 1.0)
        lc_g = port_camera_utils.load_cam(-1, 0, g, 1.0, device="cpu")
        np.testing.assert_array_equal(lc_g.gt_image.numpy(), lc_w.gt_image)
        for key in ("world_view_transform", "full_proj_transform", "camera_center",
                    "tanfovx", "tanfovy"):
            np.testing.assert_allclose(
                getattr(lc_g.camera, key).numpy(), np.asarray(getattr(lc_w.camera, key)),
                atol=1e-6, rtol=0, err_msg=key,
            )


def test_flagship_gt_and_cameras_match_jax():
    _compare_scene(os.path.join(ROOT, "data", "flagship800"), "test", False)


@pytest.mark.parametrize("white", [False, True])
def test_rgba_scene_matches_jax(tmp_path, white):
    """RGBA frames: the composite truncates to bytes as the JAX reader does."""
    rng = np.random.default_rng(int(white))
    frames = []
    for i in range(2):
        img = rng.integers(0, 256, (20, 28, 4), dtype=np.uint8)
        Image.fromarray(img, "RGBA").save(tmp_path / f"r_{i}.png")
        c2w = np.eye(4)
        c2w[:3, 3] = [0.5 * i, -1.0, 3.0]
        frames.append({"file_path": f"./r_{i}", "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_test.json").write_text(
        json.dumps({"camera_angle_x": 0.69, "frames": frames})
    )
    _compare_scene(str(tmp_path), "test", white)


@pytest.mark.parametrize("resolution,error", [(0, ZeroDivisionError), (-2, ValueError)])
def test_other_resolutions_raise(resolution, error):
    """A resolution that gives no image size raises in both packages (the
    factors, -1 and target widths are held to JAX in
    tests/test_torch_camera_utils.py)."""
    path = os.path.join(ROOT, "data", "flagship800")
    info = port_readers.read_cameras_from_transforms(path, "transforms_test.json", False)[0]
    want = readers.read_cameras_from_transforms(path, "transforms_test.json", False)[0]
    with pytest.raises(error):
        camera_utils.load_cam(resolution, 0, want, 1.0)
    with pytest.raises(error):
        port_camera_utils.load_cam(resolution, 0, info, 1.0, device="cpu")
