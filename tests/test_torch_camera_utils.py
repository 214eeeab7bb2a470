"""The port's `load_cam` (`sgs_tpu_torch.data.camera_utils`) against the
JAX package's on the same CameraInfo: the GT image bit for bit and the
camera within 1e-7, at every resolution case (the factors 1, 2, 4 and 8,
-1 at and above 1,600 px wide, target widths down and up, a resolution
scale), on RGB, RGBA and gray images; the large-image INFO line printed
once; JAX's LoadedCamera fields (`uid` the index, `colmap_id` the info's
uid); and `camera_to_json` equal to JAX's."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from PIL import Image

from sgs_tpu.data import camera_utils as jax_cu
from sgs_tpu.data.readers import CameraInfo as JaxCameraInfo
from sgs_tpu_torch.data import camera_utils as cu
from sgs_tpu_torch.data.readers import CameraInfo

torch.set_num_threads(1)
CAMERA_KEYS = ("world_view_transform", "full_proj_transform", "camera_center", "tanfovx", "tanfovy")


def _infos(h, w, channels, seed=0, uid=5):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    if channels == 4:
        img[..., 3] = rng.choice(np.array([0, 1, 128, 255, 60], np.uint8), size=(h, w))
    a = 0.3 + 0.1 * seed
    R = np.array([[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0], [-np.sin(a), 0.0, np.cos(a)]])
    T = np.array([0.2, -0.1, 3.0 + seed])
    fovx = 0.9
    fovy = 2 * np.arctan(np.tan(fovx / 2) * h / w)
    pil = Image.fromarray(img[:, :, 0] if channels == 1 else img)
    common = dict(uid=uid, R=R, T=T, FovY=fovy, FovX=fovx, image_path="x.png", image_name="x",
                  width=w, height=h)
    return JaxCameraInfo(image=pil, **common), CameraInfo(image=img, **common)


def _compare(want, got):
    np.testing.assert_array_equal(got.gt_image.numpy(), want.gt_image)
    assert got.gt_image.dtype == torch.float32
    assert (got.camera.image_width, got.camera.image_height) == (
        want.camera.image_width, want.camera.image_height)
    for key in CAMERA_KEYS:
        np.testing.assert_allclose(getattr(got.camera, key).numpy(), np.asarray(getattr(want.camera, key)),
                                   atol=1e-7, rtol=0, err_msg=key)
    assert (got.image_name, got.uid, got.colmap_id) == (want.image_name, want.uid, want.colmap_id)


@pytest.mark.parametrize("channels", [3, 4, 1])
@pytest.mark.parametrize("resolution,scale,shape", [
    (1, 1.0, (30, 44)), (2, 1.0, (30, 44)), (4, 1.0, (30, 45)), (8, 1.0, (33, 70)),
    (2, 2.0, (30, 44)),            # a resolution scale
    (-1, 1.0, (30, 44)),           # kept as it is
    (-1, 1.0, (12, 1700)),         # above 1,600 px wide: to 1,600
    (-1, 1.0, (5, 1601)),          # 1,599 wide: int(1601 / (1601 / 1600))
    (-1, 2.0, (30, 44)),
    (23, 1.0, (30, 44)),           # a target width, down
    (60, 1.0, (20, 44)),           # and up
])
def test_load_cam_matches_jax(resolution, scale, shape, channels, monkeypatch):
    monkeypatch.setattr(jax_cu, "_WARNED", True)
    monkeypatch.setitem(cu._warned, "large", True)
    jax_info, info = _infos(*shape, channels, seed=resolution % 5)
    want = jax_cu.load_cam(resolution, 3, jax_info, scale)
    got = cu.load_cam(resolution, 3, info, scale, device="cpu")
    _compare(want, got)
    assert got.gt_image.shape[0] == (1 if channels == 1 else 3)


def test_large_image_info_printed_once(monkeypatch):
    monkeypatch.setattr(jax_cu, "_WARNED", False)
    monkeypatch.setitem(cu._warned, "large", False)
    jax_info, info = _infos(6, 2000, 3)
    jax_out, port_out = io.StringIO(), io.StringIO()
    with redirect_stdout(jax_out):
        for _ in range(2):
            jax_cu.load_cam(-1, 0, jax_info, 1.0)
    with redirect_stdout(port_out):
        cams = [cu.load_cam(-1, 0, info, 1.0, device="cpu") for _ in range(2)]
    assert port_out.getvalue() == jax_out.getvalue() == cu.LARGE_IMAGE_INFO + "\n"
    assert (cams[0].camera.image_width, cams[0].camera.image_height) == (1600, 4)


def test_camera_list_fields_match_jax():
    """`uid` is the index in the list and `colmap_id` the info's uid."""
    pairs = [_infos(8, 10, 3, seed=s, uid=40 + s) for s in range(3)]
    want = jax_cu.camera_list_from_infos([p[0] for p in pairs], 1.0, -1)
    got = cu.camera_list_from_infos([p[1] for p in pairs], 1.0, -1, device="cpu")
    assert [(c.uid, c.colmap_id) for c in got] == [(0, 40), (1, 41), (2, 42)]
    for w, g in zip(want, got):
        _compare(w, g)
    assert [cu.camera_to_json(i, p[1]) for i, p in enumerate(pairs)] == [
        jax_cu.camera_to_json(i, p[0]) for i, p in enumerate(pairs)]


def test_gray_alpha_raises():
    _, info = _infos(8, 10, 3)
    info.image = np.zeros((8, 10, 2), np.uint8)
    with pytest.raises(ValueError, match="gray-alpha"):
        cu.load_cam(-1, 0, info, 1.0, device="cpu")
