"""The port's COLMAP reader and writers (`sgs_tpu_torch.data.colmap`),
`read_colmap_scene` and the COLMAP `Scene` against the JAX package's, on
the toy COLMAP scene of `sgs_tpu.utils.toy_scene.make_colmap_dataset`
(binary) and its text copy:
- the binary writers write the same bytes, and each package reads what
  the other wrote, binary and text;
- names, order, the llffhold split, R, T, the FoVs, the extent, the
  decoded images and the `points3D.ply` bytes are equal;
- an OPENCV camera is read, a SIMPLE_RADIAL one raises in both;
- `Scene`: the counts, the shuffled order under one `random` seed, the
  init cloud (bit for bit) and pool (within 1e-6), and the `cameras.json`
  and `input.ply` bytes;
- images the port cannot decode (CMYK JPEG, palette, 16-bit) raise an
  error that names the file and the format; a progressive JPEG, complete
  or with its last scans left out (block smoothing), loads with the GT of
  JAX's `load_cam` bit for bit; a gray image trains in both (its
  one-channel GT broadcasts in both losses), a gray-alpha one in neither;
- the port's train CLI at `-r 2` raises the test PSNR of the toy scene of
  tests/test_train_e2e.py:106, and its render CLI at `-r 2` gives the JAX
  render CLI's images within 3e-5;
- `chip_smoke.py`'s per-view tables of the JAX package on the flagship's
  COLMAP copy are those of the committed run (runs/colmap_flagship800_jax).
"""

import json
import os
import random
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

import render as jax_render_cli
from jpeg_fixtures import keep_scans, pil_bytes, sample_image
from sgs_tpu.data import colmap as jax_colmap
from sgs_tpu.data import readers as jax_readers
from sgs_tpu.data.camera_utils import load_cam as jax_load_cam
from sgs_tpu.data.ply import save_gaussian_ply
from sgs_tpu.data.scene import Scene as JaxScene
from sgs_tpu.ops.ssim import l1_loss as jax_l1, ssim as jax_ssim
from sgs_tpu.utils import config as jax_config
from sgs_tpu_torch.data import colmap, readers
from sgs_tpu_torch.data.camera_utils import load_cam
from sgs_tpu_torch.data.scene import Scene
from sgs_tpu_torch.ops.ssim import l1_loss, ssim
from sgs_tpu_torch.render import cli as render_cli
from sgs_tpu_torch.train.__main__ import main as train_main
from sgs_tpu_torch.utils import config

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """(binary scene, text copy): the toy COLMAP scene of
    tests/test_train_e2e.py:106 at 32x32, 8 views."""
    from sgs_tpu.utils.toy_scene import make_colmap_dataset

    root = tmp_path_factory.mktemp("colmap")
    binary, text = str(root / "bin"), str(root / "txt")
    make_colmap_dataset(binary, n_views=8, width=32, height=32, n_gaussians=80)
    sparse = os.path.join(binary, "sparse", "0")
    shutil.copytree(os.path.join(binary, "images"), os.path.join(text, "images"))
    os.makedirs(os.path.join(text, "sparse", "0"))
    out = os.path.join(text, "sparse", "0")
    colmap.write_cameras_text(os.path.join(out, "cameras.txt"),
                              colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin")))
    colmap.write_images_text(os.path.join(out, "images.txt"),
                             colmap.read_images_binary(os.path.join(sparse, "images.bin")))
    xyz, rgb, _ = colmap.read_points3D_binary(os.path.join(sparse, "points3D.bin"))
    colmap.write_points3D_text(os.path.join(out, "points3D.txt"), xyz, rgb)
    return binary, text


def _fresh(src, dst):
    """A copy of a scene without the points3D.ply its reader writes."""
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("points3D.ply"))
    return str(dst)


def _same_cameras(got, want):
    assert [c.image_name for c in got] == [c.image_name for c in want]
    for g, w in zip(got, want):
        assert (g.uid, g.width, g.height) == (w.uid, w.width, w.height)
        assert g.image_path.split(os.sep)[-2:] == w.image_path.split(os.sep)[-2:]
        assert g.FovX == w.FovX and g.FovY == w.FovY
        np.testing.assert_array_equal(g.R, w.R)
        np.testing.assert_array_equal(g.T, w.T)
        np.testing.assert_array_equal(g.image, np.asarray(w.image))


@pytest.mark.parametrize("form", ["bin", "txt"])
def test_read_colmap_scene_matches_jax(toy, form, tmp_path):
    src = toy[0] if form == "bin" else toy[1]
    a, b = _fresh(src, tmp_path / "a"), _fresh(src, tmp_path / "b")
    want = jax_readers.read_colmap_scene(a, None, True)
    got = readers.read_colmap_scene(b, None, True)
    assert (len(got.train_cameras), len(got.test_cameras)) == (7, 1)
    _same_cameras(got.train_cameras, want.train_cameras)
    _same_cameras(got.test_cameras, want.test_cameras)
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  want.nerf_normalization["translate"])
    with open(got.ply_path, "rb") as f, open(want.ply_path, "rb") as g:
        assert f.read() == g.read()
    for k in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(got.point_cloud, k), getattr(want.point_cloud, k))
    full = readers.read_colmap_scene(b, None, False)
    assert (len(full.train_cameras), len(full.test_cameras)) == (8, 0)


def test_writers_and_readers_round_trip_with_jax(toy, tmp_path):
    sparse = os.path.join(toy[0], "sparse", "0")
    cams = jax_colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    imgs = jax_colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb, _ = jax_colmap.read_points3D_binary(os.path.join(sparse, "points3D.bin"))
    writers = [("cameras", cams), ("images", imgs)]
    for name, data in writers:
        getattr(colmap, f"write_{name}_binary")(str(tmp_path / f"{name}.bin"), data)
        getattr(jax_colmap, f"write_{name}_binary")(str(tmp_path / f"{name}_jax.bin"), data)
        assert (tmp_path / f"{name}.bin").read_bytes() == (tmp_path / f"{name}_jax.bin").read_bytes()
    colmap.write_points3D_binary(str(tmp_path / "p.bin"), xyz, rgb.astype(np.uint8))
    jax_colmap.write_points3D_binary(str(tmp_path / "p_jax.bin"), xyz, rgb.astype(np.uint8))
    assert (tmp_path / "p.bin").read_bytes() == (tmp_path / "p_jax.bin").read_bytes()

    text = os.path.join(toy[1], "sparse", "0")
    for fmt, base, ext in (("binary", sparse, "bin"), ("text", text, "txt")):
        c = getattr(jax_colmap, f"read_cameras_{fmt}")(os.path.join(base, f"cameras.{ext}"))
        cp = getattr(colmap, f"read_cameras_{fmt}")(os.path.join(base, f"cameras.{ext}"))
        assert c.keys() == cp.keys() == cams.keys()
        for k in cams:
            assert (cp[k].model, cp[k].width, cp[k].height) == (cams[k].model, cams[k].width, cams[k].height)
            np.testing.assert_array_equal(cp[k].params, cams[k].params)
            np.testing.assert_array_equal(c[k].params, cams[k].params)
        i = getattr(jax_colmap, f"read_images_{fmt}")(os.path.join(base, f"images.{ext}"))
        ip = getattr(colmap, f"read_images_{fmt}")(os.path.join(base, f"images.{ext}"))
        assert i.keys() == ip.keys() == imgs.keys()
        for k in imgs:
            for got in (i[k], ip[k]):
                assert (got.name, got.camera_id) == (imgs[k].name, imgs[k].camera_id)
                np.testing.assert_array_equal(got.qvec, imgs[k].qvec)
                np.testing.assert_array_equal(got.tvec, imgs[k].tvec)
        for got in (getattr(jax_colmap, f"read_points3D_{fmt}")(os.path.join(base, f"points3D.{ext}")),
                    getattr(colmap, f"read_points3D_{fmt}")(os.path.join(base, f"points3D.{ext}"))):
            np.testing.assert_array_equal(got[0], xyz)
            np.testing.assert_array_equal(got[1], rgb)
    R = colmap.qvec2rotmat(imgs[3].qvec)
    np.testing.assert_array_equal(R, jax_colmap.qvec2rotmat(imgs[3].qvec))
    np.testing.assert_array_equal(colmap.rotmat2qvec(R), jax_colmap.rotmat2qvec(R))


@pytest.mark.parametrize("model,params,ok", [
    ("OPENCV", [30.0, 31.0, 16.0, 16.0, 0.1, -0.05, 0.001, 0.002], True),
    ("SIMPLE_PINHOLE", [30.0, 16.0, 16.0], True),
    ("SIMPLE_RADIAL", [30.0, 16.0, 16.0, 0.1], False),
])
def test_camera_models(toy, tmp_path, model, params, ok):
    scenes = [_fresh(toy[0], tmp_path / "a"), _fresh(toy[0], tmp_path / "b")]
    for src in scenes:
        cams = {1: colmap.ColmapCamera(1, model, 32, 32, np.array(params))}
        colmap.write_cameras_binary(os.path.join(src, "sparse", "0", "cameras.bin"), cams)
    if not ok:
        with pytest.raises(ValueError, match="SIMPLE_RADIAL not handled") as want:
            jax_readers.read_colmap_scene(scenes[0], None, True)
        with pytest.raises(ValueError, match="SIMPLE_RADIAL not handled") as got:
            readers.read_colmap_scene(scenes[1], None, True)
        assert str(got.value) == str(want.value)
        return
    want = jax_readers.read_colmap_scene(scenes[0], None, True)
    got = readers.read_colmap_scene(scenes[1], None, True)
    _same_cameras(got.train_cameras + got.test_cameras, want.train_cameras + want.test_cameras)
    assert got.train_cameras[0].FovX != got.train_cameras[0].FovY or model == "SIMPLE_PINHOLE"


def test_scene_matches_jax(toy, tmp_path):
    a, b = _fresh(toy[0], tmp_path / "a"), _fresh(toy[0], tmp_path / "b")
    random.seed(3)
    want = JaxScene(jax_config.ModelParams(source_path=a, model_path=str(tmp_path / "ma"), eval=True,
                                           resolution=2), pool_capacity=1024)
    random.seed(3)
    got = Scene(config.ModelParams(source_path=b, model_path=str(tmp_path / "mb"), eval=True,
                                   resolution=2), device="cpu")
    assert got.scene_info.ply_path.endswith(os.path.join("sparse", "0", "points3D.ply"))
    for mine, theirs in ((got.getTrainCameras(), want.getTrainCameras()),
                         (got.getTestCameras(), want.getTestCameras())):
        assert [c.image_name for c in mine] == [c.image_name for c in theirs]
        assert [(c.uid, c.colmap_id) for c in mine] == [(c.uid, c.colmap_id) for c in theirs]
        for m, t in zip(mine, theirs):
            assert m.gt_image.shape == (3, 16, 16)
            np.testing.assert_array_equal(m.gt_image.numpy(), t.gt_image)
    assert got.cameras_extent == want.cameras_extent
    for name in ("cameras.json", "input.ply"):
        assert (tmp_path / "mb" / name).read_bytes() == (tmp_path / "ma" / name).read_bytes()
    np.testing.assert_array_equal(got.init_pcd.points, want.scene_info.point_cloud.points)
    np.testing.assert_array_equal(got.init_pcd.colors, want.scene_info.point_cloud.colors)
    mine, theirs = got.pool.compact_arrays(), want.pool.compact_arrays()
    assert mine.keys() == theirs.keys()
    for k in mine:
        if k != "scaling":
            np.testing.assert_allclose(mine[k], theirs[k], atol=1e-6, rtol=0, err_msg=k)
    # the init scale is log sqrt of the mean squared distance to the 3
    # nearest points, d2 = |q|^2 + |p|^2 - 2 q.p in float32 by two
    # different matrix products: d2 agrees to a few float32 ulps of |p|^2
    pts = got.init_pcd.points
    ulp = np.finfo(np.float32).eps * float((pts.astype(np.float64) ** 2).sum(axis=1).max())
    np.testing.assert_allclose(np.exp(2.0 * mine["scaling"].astype(np.float64)),
                               np.exp(2.0 * theirs["scaling"].astype(np.float64)), atol=8 * ulp, rtol=1e-6)


def test_images_flag_reads_another_directory(toy, tmp_path):
    """`-i images_4`: the images come from that directory in both packages."""
    scenes = []
    for name in ("a", "b"):
        src = _fresh(toy[0], tmp_path / name)
        os.rename(os.path.join(src, "images"), os.path.join(src, "images_4"))
        scenes.append(src)
    want = JaxScene(jax_config.ModelParams(source_path=scenes[0], model_path="", images="images_4",
                                           eval=True), shuffle=False, pool_capacity=1024)
    got = Scene(config.ModelParams(source_path=scenes[1], model_path="", images="images_4", eval=True),
                shuffle=False, device="cpu")
    assert len(got.getTrainCameras()) == 7
    for m, t in zip(got.getTrainCameras() + got.getTestCameras(),
                    want.getTrainCameras() + want.getTestCameras()):
        assert m.image_name == t.image_name
        np.testing.assert_array_equal(m.gt_image.numpy(), t.gt_image)
    with pytest.raises(FileNotFoundError):
        readers.read_colmap_scene(scenes[1], None, True)


def _one_image_scene(toy, dst, write):
    """The binary toy scene with its first image replaced by `write(path)`'s."""
    src = _fresh(toy[0], dst)
    path = os.path.join(src, "images", "img_000.png")
    write(path)
    return src, path


@pytest.mark.parametrize("kind,match", [
    ("jpeg", "JPEG"), ("palette", "palette"), ("16bit", "16-bit"),
])
def test_undecodable_images_raise(toy, tmp_path, kind, match):
    rgb = np.random.default_rng(0).integers(0, 256, (32, 32, 3), dtype=np.uint8)

    def write(path):
        if kind == "jpeg":
            Image.fromarray(rgb).convert("CMYK").save(path, format="JPEG")
        elif kind == "palette":
            Image.fromarray(rgb).convert("P").save(path)
        else:
            Image.fromarray(rgb[:, :, 0].astype(np.uint16) * 257).save(path)

    src, path = _one_image_scene(toy, tmp_path / "s", write)
    with pytest.raises(ValueError, match=match) as err:
        readers.read_colmap_scene(src, None, True)
    assert path in str(err.value)


@pytest.mark.parametrize("scans", [None, 3])
def test_progressive_jpeg_loads_as_in_jax(toy, tmp_path, scans):
    """A progressive JPEG in the scene (all its scans, or the first three
    only: libjpeg smooths the blocks) gives JAX's GT at -r 1 and -r 2."""
    rgb = sample_image(32, 32, 5)

    def write(path):
        data = pil_bytes(rgb, quality=90, subsampling=2, progressive=True)
        with open(path, "wb") as f:
            f.write(keep_scans(data, scans) if scans else data)

    src, _ = _one_image_scene(toy, tmp_path / "p", write)
    want = jax_readers.read_colmap_scene(src, None, True).test_cameras[0]
    got = readers.read_colmap_scene(src, None, True, device="cpu").test_cameras[0]
    assert got.image_name == want.image_name == "img_000"
    for resolution in (1, 2):
        jcam, cam = jax_load_cam(resolution, 0, want, 1.0), load_cam(resolution, 0, got, 1.0, device="cpu")
        assert cam.gt_image.shape == (3, 32 // resolution, 32 // resolution)
        np.testing.assert_array_equal(cam.gt_image.numpy(), jcam.gt_image)


def test_gray_trains_in_both_gray_alpha_in_neither(toy, tmp_path):
    """A gray image's GT keeps one channel in both packages and both
    losses broadcast it; a gray-alpha GT keeps two channels in JAX, whose
    loss then fails, and the port refuses it when loading."""
    gray = np.random.default_rng(1).integers(0, 256, (32, 32), dtype=np.uint8)
    src, _ = _one_image_scene(toy, tmp_path / "g", lambda p: Image.fromarray(gray).save(p))
    want = [c for c in jax_readers.read_colmap_scene(src, None, True).test_cameras][0]
    got = readers.read_colmap_scene(src, None, True).test_cameras[0]
    assert got.image.shape == (32, 32, 1)
    jcam, cam = jax_load_cam(2, 0, want, 1.0), load_cam(2, 0, got, 1.0, device="cpu")
    assert cam.gt_image.shape == (1, 16, 16)
    np.testing.assert_array_equal(cam.gt_image.numpy(), jcam.gt_image)
    image = np.random.default_rng(2).random((3, 16, 16), dtype=np.float32)
    np.testing.assert_allclose(float(l1_loss(torch.from_numpy(image), cam.gt_image)),
                               float(jax_l1(image, jcam.gt_image)), rtol=1e-6)
    np.testing.assert_allclose(float(ssim(torch.from_numpy(image), cam.gt_image)),
                               float(jax_ssim(image, jcam.gt_image)), rtol=1e-5)

    la = np.stack([gray, gray // 2], axis=2)
    src, _ = _one_image_scene(toy, tmp_path / "la", lambda p: Image.fromarray(la, "LA").save(p))
    want = jax_readers.read_colmap_scene(src, None, True).test_cameras[0]
    jcam = jax_load_cam(-1, 0, want, 1.0)
    assert jcam.gt_image.shape == (2, 32, 32)
    with pytest.raises((TypeError, ValueError), match="broadcast"):
        jax_l1(image.repeat(2, 1).repeat(2, 2), jcam.gt_image)
    got = readers.read_colmap_scene(src, None, True).test_cameras[0]
    with pytest.raises(ValueError, match="gray-alpha"):
        load_cam(-1, 0, got, 1.0, device="cpu")


def test_train_cli_at_half_resolution_raises_psnr(toy, tmp_path):
    src = _fresh(toy[0], tmp_path / "scene")
    model = str(tmp_path / "model")
    # 40 steps without densification: the plain raster walks the one 16x16
    # tile's whole list per step on the CPU
    train_main(["-s", src, "-m", model, "-r", "2", "--eval", "--device", "cpu",
                "--iterations", "40", "--densify_until_iter", "-1", "--position_lr_max_steps", "40",
                "--test_iterations", "1", "40", "--save_iterations", "40",
                "--checkpoint_iterations", "40"])
    rows = open(os.path.join(model, "losses.tsv")).read().strip().splitlines()
    first, last = rows[1].split("\t"), rows[-1].split("\t")
    assert float(last[2]) > float(first[2]) + 3.0, (first, last)
    cfg = open(os.path.join(model, "cfg_args")).read()
    assert "resolution=2" in cfg and "images='images'" in cfg


def test_render_cli_at_half_resolution_matches_jax(toy, tmp_path, monkeypatch):
    """The port's render CLI and JAX's `render.render_sets` on the same
    trained PLY at -r 2: every render within 3e-5 of JAX's and every GT
    equal, before quantisation."""
    src = _fresh(toy[0], tmp_path / "scene")
    rng = np.random.default_rng(4)
    n = 300
    xyz = (rng.normal(size=(n, 3)) * 0.5).astype(np.float32)
    dc = rng.normal(size=(n, 1, 3)).astype(np.float32)
    rest = (rng.normal(size=(n, 15, 3)) * 0.1).astype(np.float32)
    opacity = rng.uniform(-1, 3, (n, 1)).astype(np.float32)
    scaling = rng.uniform(-4, -2.5, (n, 3)).astype(np.float32)
    rotation = rng.normal(size=(n, 4)).astype(np.float32)
    outputs = {}
    for pkg in ("jax", "port"):
        ply = tmp_path / pkg / "point_cloud" / "iteration_7" / "point_cloud.ply"
        save_gaussian_ply(str(ply), xyz, dc, rest, opacity, scaling, rotation)
        outputs[pkg] = []
    monkeypatch.setattr(jax_render_cli, "save_png",
                        lambda path, img: outputs["jax"].append((path, np.asarray(img))))
    monkeypatch.setattr(render_cli, "save_png",
                        lambda path, img: outputs["port"].append((path, img.numpy())))
    jax_render_cli.render_sets(
        jax_config.ModelParams(source_path=src, model_path=str(tmp_path / "jax"), resolution=2,
                               eval=True), 7, jax_config.PipelineParams(), False, False)
    render_cli.main(["-m", str(tmp_path / "port"), "-s", src, "-r", "2", "--iteration", "7", "--eval",
                     "--quiet", "--device", "cpu"])
    got, want = outputs["port"], outputs["jax"]
    assert len(got) == len(want) == 16
    for (gp, g), (wp, w) in zip(got, want):
        assert os.path.relpath(gp, tmp_path / "port") == os.path.relpath(wp, tmp_path / "jax")
        assert g.shape == w.shape == (3, 16, 16)
        if "/gt/" in gp:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=3e-5, rtol=0)


@pytest.mark.parametrize("resolution,run", [(-1, "model_full"), (2, "model_half")])
def test_smoke_holds_the_committed_jax_numbers(resolution, run):
    """chip_smoke.py phase 11 holds the port's render and metrics CLIs on
    the COLMAP copy of data/flagship800 to the JAX package's per-view
    numbers: they are those of the committed run, view by view in name
    order."""
    import chip_smoke

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "runs", "colmap_flagship800_jax", run, "per_view.json")
    with open(path) as f:
        per_view = json.load(f)["ours_15000"]
    names = sorted(per_view["PSNR"])
    assert len(names) == 7  # llffhold 8 over 56 images
    assert chip_smoke.JAX_COLMAP_PSNR[resolution] == [per_view["PSNR"][n] for n in names]
    assert chip_smoke.JAX_COLMAP_SSIM[resolution] == [per_view["SSIM"][n] for n in names]
