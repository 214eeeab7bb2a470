"""The port's Zero123 and mesh readers (`sgs_tpu_torch.data.readers`,
`sgs_tpu_torch.data.mesh`) and the Zero123 drivers against the JAX
package's:
- the eight fixture tests of tests/test_mesh_zero123.py, run on the port
  with the same fixtures (the first-10 split and 35/32 mm intrinsics, the
  pose convention, the alpha composite, the GLB round trip, node
  transforms, decimation, the normalisation and axis swap, the
  mesh_max_faces guard);
- GLB centroids equal JAX's bit for bit on a scene graph with nested
  nodes, a matrix, TRS transforms, a strided view and two primitives;
  Zero123 cameras equal; `read_mesh_scene` under one numpy seed gives the
  same points, colours and points3d.ply bytes;
- the Zero123 `Scene` against JAX's: counts, the shuffled order, the
  cameras.json and input.ply bytes and the pool; the mesh3d.ply marker
  raises in both;
- `python -m sgs_tpu_torch.train_zero123` (and `_2`) pass the JAX
  drivers' argv, with `train.py` swapped for the port's module.
"""

import json
import os
import random
import runpy
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from sgs_tpu.data import mesh as jax_mesh
from sgs_tpu.data import readers as jax_readers
from sgs_tpu.data.scene import Scene as JaxScene
from sgs_tpu.utils import config as jax_config
from sgs_tpu_torch import train_zero123
from sgs_tpu_torch.data import mesh, readers
from sgs_tpu_torch.data.scene import Scene
from sgs_tpu_torch.utils import config
from test_mesh_zero123 import _minimal_glb, _write_zero123_dir

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------- tests/test_mesh_zero123.py

def test_zero123_split_and_intrinsics(tmp_path):
    d = str(tmp_path / "z123")
    _write_zero123_dir(d, n_images=12)
    train = readers.read_cameras_from_zero123(d, white_background=True, train_split=True)
    test = readers.read_cameras_from_zero123(d, white_background=True, train_split=False)
    assert len(train) == 10 and len(test) == 2
    assert train[0].image_name == "000" and test[0].image_name == "010"
    fov = 2.0 * np.arctan(32.0 / (2.0 * 35.0))
    for c in train + test:
        assert c.FovX == pytest.approx(fov) and c.FovY == pytest.approx(fov)
        assert c.width == 8 and c.height == 8


def test_zero123_pose_convention(tmp_path):
    d = str(tmp_path / "z123")
    poses = _write_zero123_dir(d, n_images=12)
    cams = readers.read_cameras_from_zero123(d, white_background=False, train_split=True)
    for i, c in enumerate(cams):
        w2c = poses[i].copy()
        w2c[1:3, :3] *= -1
        np.testing.assert_allclose(c.R, w2c[:3, :3].T, atol=1e-12)
        np.testing.assert_allclose(c.T, -w2c[:3, 3], atol=1e-12)


def test_zero123_alpha_composite(tmp_path):
    d = str(tmp_path / "z123")
    _write_zero123_dir(d, n_images=10)
    w = readers.read_cameras_from_zero123(d, white_background=True, train_split=True)[0].image
    b = readers.read_cameras_from_zero123(d, white_background=False, train_split=True)[0].image
    a = 128.0 / 255.0
    assert w[1, 1, 0] == int((200 / 255.0 * a + 1.0 * (1 - a)) * 255)
    assert b[1, 1, 0] == int(200 / 255.0 * a * 255)
    assert tuple(w[0, 0]) == (255, 255, 255) and tuple(b[0, 0]) == (0, 0, 0)


def test_glb_roundtrip_identity(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.uint16)
    p = str(tmp_path / "m.glb")
    _minimal_glb(p, verts, faces)
    prims = mesh.load_glb_triangles(p)
    assert len(prims) == 1
    v, f = prims[0]
    np.testing.assert_allclose(v, verts, atol=0)
    np.testing.assert_array_equal(f, faces.astype(np.int64))


def test_glb_node_transform_applied(tmp_path):
    verts = np.array([[0, 0, 0], [3, 0, 0], [0, 3, 0]], np.float32)
    p = str(tmp_path / "m.glb")
    _minimal_glb(p, verts, np.array([[0, 1, 2]], np.uint16), translation=[1.0, 2.0, 3.0],
                 scale=[2.0, 2.0, 2.0])
    np.testing.assert_allclose(mesh.load_mesh_triangle_centroids(p), [[3.0, 4.0, 3.0]], atol=1e-6)


def test_glb_decimate_subsample(tmp_path):
    n = 20
    verts = np.zeros((3 * n, 3), np.float32)
    for k in range(3):
        verts[k::3, 0] = np.arange(n)
    p = str(tmp_path / "m.glb")
    _minimal_glb(p, verts, np.arange(3 * n, dtype=np.uint16).reshape(n, 3))
    assert len(mesh.load_mesh_triangle_centroids(p)) == n
    half = mesh.load_mesh_triangle_centroids(p, decimate_factor=2.0)
    assert len(half) == n // 2
    assert set(np.round(half[:, 0]).astype(int)) <= set(range(n))


def test_mesh_scene_normalization_and_axis_swap(tmp_path):
    d = str(tmp_path / "scene")
    _write_zero123_dir(d, n_images=12)
    glb = str(tmp_path / "obj.glb")
    _minimal_glb(glb, np.array([[0, 0, 0], [6, 0, 0], [0, 6, 0]], np.float32),
                 np.array([[0, 1, 2]], np.uint16))
    with open(str(tmp_path / "obj_normalization.json"), "w") as f:
        json.dump({"scale": 0.5, "offset": [1.0, 2.0, 3.0]}, f)
    info = readers.read_mesh_scene(d, white_background=True, eval_split=True, obj_path=glb)
    np.testing.assert_allclose(info.point_cloud.points, [[2.0, -3.0, 3.0]], atol=1e-6)
    assert len(info.train_cameras) == 10 and len(info.test_cameras) == 2
    assert os.path.exists(info.ply_path)


def test_mesh_scene_max_faces_guard(tmp_path):
    d = str(tmp_path / "scene")
    _write_zero123_dir(d, n_images=10)
    glb = str(tmp_path / "obj.glb")
    _minimal_glb(glb, np.zeros((6, 3), np.float32), np.arange(6, dtype=np.uint16).reshape(2, 3))
    with pytest.raises(RuntimeError, match="mesh_max_faces"):
        readers.read_mesh_scene(d, white_background=True, eval_split=True, obj_path=glb,
                                mesh_max_faces=1)


# ------------------------------------------------------ parity with JAX

def _graph_glb(path):
    """Two meshes: one a strided POSITION view with two primitives, one
    instanced by two nodes (a matrix under a rotated, scaled parent)."""
    rng = np.random.default_rng(7)
    pos_a = rng.normal(size=(9, 3)).astype(np.float32)
    pos_b = rng.normal(size=(6, 3)).astype(np.float32)
    strided = np.concatenate([pos_a, np.ones((9, 1), np.float32)], axis=1)  # 16-byte stride
    idx_a = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8], np.uint32)
    idx_b = np.array([2, 1, 0, 5, 4, 3], np.uint16)
    parts = [strided.tobytes(), idx_a.tobytes(), pos_b.tobytes(), idx_b.tobytes()]
    offsets = np.cumsum([0] + [len(p) for p in parts[:-1]]).tolist()
    blob = b"".join(parts)
    blob += b"\x00" * ((-len(blob)) % 4)
    q = np.array([0.1, 0.7, -0.2, 0.5])
    q /= np.linalg.norm(q)
    matrix = np.eye(4)
    matrix[:3, 3] = [0.5, -1.0, 2.0]
    matrix[0, 1] = 0.3
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0, 2]}],
        "nodes": [
            {"mesh": 0, "children": [1], "rotation": q.tolist(), "scale": [1.5, 0.5, 2.0],
             "translation": [0.1, 0.2, 0.3]},
            {"mesh": 1, "matrix": matrix.T.reshape(-1).tolist()},
            {"mesh": 1},
        ],
        "meshes": [
            {"primitives": [{"attributes": {"POSITION": 0}, "indices": 1},
                            {"attributes": {"POSITION": 0}, "mode": 1}]},
            {"primitives": [{"attributes": {"POSITION": 2}, "indices": 3, "mode": 4}]},
        ],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 9, "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": 9, "type": "SCALAR"},
            {"bufferView": 2, "componentType": 5126, "count": 6, "type": "VEC3"},
            {"bufferView": 3, "componentType": 5123, "count": 6, "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": offsets[0], "byteLength": len(parts[0]), "byteStride": 16},
            {"buffer": 0, "byteOffset": offsets[1], "byteLength": len(parts[1])},
            {"buffer": 0, "byteOffset": offsets[2], "byteLength": len(parts[2])},
            {"buffer": 0, "byteOffset": offsets[3], "byteLength": len(parts[3])},
        ],
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js) + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
        f.write(struct.pack("<II", len(blob), 0x004E4942) + blob)


@pytest.mark.parametrize("decimate", [1.0, 1.5])
def test_glb_centroids_match_jax(tmp_path, decimate):
    p = str(tmp_path / "graph.glb")
    _graph_glb(p)
    want = jax_mesh.load_mesh_triangle_centroids(p, decimate)
    got = mesh.load_mesh_triangle_centroids(p, decimate)
    assert got.dtype == want.dtype and got.shape == want.shape
    # 3 triangles of mesh 0 (its line primitive skipped), 2 of mesh 1 twice
    assert got.shape[0] == (7 if decimate == 1.0 else 4)
    np.testing.assert_array_equal(got, want)
    for (gv, gf), (wv, wf) in zip(mesh.load_glb_triangles(p), jax_mesh.load_glb_triangles(p)):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)


@pytest.mark.parametrize("white", [False, True])
def test_zero123_cameras_match_jax(tmp_path, white):
    d = str(tmp_path / "z")
    _write_zero123_dir(d, n_images=13, size=12)
    for split in (True, False):
        want = jax_readers.read_cameras_from_zero123(d, white, train_split=split)
        got = readers.read_cameras_from_zero123(d, white, train_split=split)
        assert len(got) == len(want) == (10 if split else 3)
        for g, w in zip(got, want):
            assert (g.uid, g.image_name, g.image_path, g.width, g.height) == (
                w.uid, w.image_name, w.image_path, w.width, w.height)
            assert (g.FovX, g.FovY) == (w.FovX, w.FovY)
            np.testing.assert_array_equal(g.R, w.R)
            np.testing.assert_array_equal(g.T, w.T)
            np.testing.assert_array_equal(g.image, np.asarray(w.image))


def _zero123_scene(tmp_path, name):
    d = str(tmp_path / name)
    _write_zero123_dir(d, n_images=12, size=16)
    glb = str(tmp_path / f"{name}.glb")
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(60, 3)).astype(np.float32)
    _minimal_glb(glb, verts, np.arange(60, dtype=np.uint16).reshape(20, 3))
    with open(glb.replace(".glb", "_normalization.json"), "w") as f:
        json.dump({"scale": 0.7, "offset": [0.1, -0.3, 0.2]}, f)
    return d, glb


def test_read_mesh_scene_matches_jax(tmp_path):
    a, glb_a = _zero123_scene(tmp_path, "a")
    b, glb_b = _zero123_scene(tmp_path, "b")
    np.random.seed(11)
    want = jax_readers.read_mesh_scene(a, True, True, obj_path=glb_a, mesh_max_faces=16_000)
    np.random.seed(11)
    got = readers.read_mesh_scene(b, True, True, obj_path=glb_b, mesh_max_faces=16_000)
    for k in ("points", "colors", "normals"):
        g, w = getattr(got.point_cloud, k), np.asarray(getattr(want.point_cloud, k))
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    with open(got.ply_path, "rb") as f, open(want.ply_path, "rb") as g:
        assert f.read() == g.read()
    assert got.nerf_normalization["radius"] == want.nerf_normalization["radius"]
    assert [c.image_name for c in got.train_cameras] == [c.image_name for c in want.train_cameras]
    with pytest.raises(NotImplementedError):
        readers.read_mesh_scene(b, True, True)


def test_zero123_scene_matches_jax(tmp_path):
    a, glb_a = _zero123_scene(tmp_path, "a")
    b, glb_b = _zero123_scene(tmp_path, "b")
    random.seed(5)
    np.random.seed(5)
    want = JaxScene(jax_config.ModelParams(source_path=a, model_path=str(tmp_path / "ma"),
                                           obj_path=glb_a, white_background=True, eval=True))
    random.seed(5)
    np.random.seed(5)
    got = Scene(config.ModelParams(source_path=b, model_path=str(tmp_path / "mb"), obj_path=glb_b,
                                   white_background=True, eval=True), device="cpu")
    assert (len(got.getTrainCameras()), len(got.getTestCameras())) == (10, 2)
    for mine, theirs in ((got.getTrainCameras(), want.getTrainCameras()),
                         (got.getTestCameras(), want.getTestCameras())):
        assert [c.image_name for c in mine] == [c.image_name for c in theirs]
        for m, t in zip(mine, theirs):
            np.testing.assert_array_equal(m.gt_image.numpy(), t.gt_image)
    for name in ("cameras.json", "input.ply"):
        assert (tmp_path / "mb" / name).read_bytes() == (tmp_path / "ma" / name).read_bytes()
    mine, theirs = got.pool.compact_arrays(), want.pool.compact_arrays()
    assert mine.keys() == theirs.keys()
    for k in mine:
        if k != "scaling":
            np.testing.assert_allclose(mine[k], theirs[k], atol=1e-6, rtol=0, err_msg=k)
    # the init scale from the knn over the mesh centroids, compared as in
    # tests/test_torch_colmap.py: d2 = |q|^2 + |p|^2 - 2 q.p in float32 by
    # two different matrix products agrees to a few float32 ulps of |p|^2
    pts = got.init_pcd.points
    ulp = np.finfo(np.float32).eps * float((pts.astype(np.float64) ** 2).sum(axis=1).max())
    np.testing.assert_allclose(np.exp(2.0 * mine["scaling"].astype(np.float64)),
                               np.exp(2.0 * theirs["scaling"].astype(np.float64)), atol=8 * ulp, rtol=1e-6)


def test_mesh_marker_raises_in_both(tmp_path):
    d, _ = _zero123_scene(tmp_path, "m")
    open(os.path.join(d, "mesh3d.ply"), "w").close()
    with pytest.raises(NotImplementedError) as want:
        JaxScene(jax_config.ModelParams(source_path=d, model_path="", eval=True))
    with pytest.raises(NotImplementedError) as got:
        Scene(config.ModelParams(source_path=d, model_path="", eval=True), device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("script,module,freeze", [
    ("train_zero123.py", "sgs_tpu_torch.train_zero123", True),
    ("train_zero123_2.py", "sgs_tpu_torch.train_zero123_2", False),
])
def test_zero123_drivers_pass_the_jax_argv(tmp_path, monkeypatch, script, module, freeze):
    manifest = tmp_path / "objects.json"
    manifest.write_text(json.dumps({"uid_a": "/objs/a.glb", "uid_b": "/objs/b.glb"}))
    monkeypatch.setenv("ZERO123_MANIFEST", str(manifest))
    monkeypatch.setenv("ZERO123_VIEWS", "/views")
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append((cmd, kw)))
    runpy.run_path(os.path.join(ROOT, script))
    want = [([sys.executable, "-m", "sgs_tpu_torch.train"] + cmd[2:], kw) for cmd, kw in calls]
    assert [cmd[1] for cmd, _ in calls] == ["train.py", "train.py"]
    calls.clear()
    if freeze:
        train_zero123.main()
    else:
        runpy.run_module(module, run_name="__main__")
    assert calls == want
    assert train_zero123.commands(freeze) == [cmd for cmd, _ in want]
