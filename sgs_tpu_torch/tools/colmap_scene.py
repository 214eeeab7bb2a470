"""COLMAP and Zero123 scenes written from the repository's own data, so
that the scene readers run on real images where no captured dataset is at
hand (`chip_smoke.py` phase 11). Everything is written with the port's
COLMAP writers (`data/colmap.py`) and PNG codec (`data/png.py`), as
`sgs_tpu/utils/toy_scene.py::make_colmap_dataset` writes its toy scene.

- `blender_to_colmap(src, dst, binary)`: a COLMAP copy of a Blender
  scene: one PINHOLE camera from `camera_angle_x`, each frame's w2c (after
  the OpenGL -> COLMAP flip) as qvec and tvec, the images (composited on
  black, as the Blender reader composites them) as `images/<split>_<stem>.png`,
  since the train and test splits both hold `r_0.png`, and `points3D`
  from the scene's `points3d.ply`;
- `capture_scene(model, poses, dst, ...)`: a COLMAP scene of the views
  that a trained model renders (Kernel A on the card) at the given w2c
  poses and size;
- `zero123_scene(model, poses, dst, ...)`: a Zero123-layout directory:
  RGBA views (alpha 1 - the final transmittance, from a black and a
  white background), `[R|T]` .npy poses in the reader's convention, and a
  GLB of one small triangle per Gaussian of the model (at most
  `GLB_FACES`) with its `_normalization.json`, placed so that the reader's
  normalisation and axis swap bring the centroids back onto the Gaussians.
"""

from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import focal2fov, fov2focal
from sgs_tpu_torch.data import colmap
from sgs_tpu_torch.data.ply import read_ply
from sgs_tpu_torch.data.png import write_png
from sgs_tpu_torch.data.readers import (
    ZERO123_FOCAL_MM,
    ZERO123_SENSOR_MM,
    composite_background,
    decode_image,
)
from sgs_tpu_torch.models.gaussians import GaussianModel
from sgs_tpu_torch.render.cli import quantize, save_png
from sgs_tpu_torch.train.loop import eval_render

Pose = Tuple[str, np.ndarray]  # (image stem, 4x4 w2c in COLMAP axes)
# the Zero123 GLB: at most the training CLI's default --mesh_max_faces
# triangles, and a normalisation that is not the identity
GLB_FACES = 16_000
GLB_SCALE, GLB_OFFSET = 0.5, (0.1, -0.2, 0.3)


def blender_poses(src: str, split: str) -> Tuple[float, List[Pose]]:
    """(camera_angle_x, [(stem, w2c), ...]) of `transforms_<split>.json`,
    with the Blender reader's OpenGL -> COLMAP flip."""
    with open(os.path.join(src, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    poses = []
    for frame in meta["frames"]:
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1
        poses.append((Path(frame["file_path"]).name, np.linalg.inv(c2w)))
    return meta["camera_angle_x"], poses


def point_cloud_u8(ply_path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(xyz (N, 3) float64, rgb (N, 3) uint8) of a point-cloud PLY."""
    v = read_ply(ply_path)["vertex"]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.uint8)
    return xyz, rgb


def write_sparse(dst: str, camera: colmap.ColmapCamera, images: Sequence[Tuple[str, np.ndarray]],
                 xyz: np.ndarray, rgb: np.ndarray, binary: bool = True) -> None:
    """sparse/0 of one camera, the images [(file name, w2c)] in order, and
    the points."""
    sparse = os.path.join(dst, "sparse", "0")
    os.makedirs(sparse, exist_ok=True)
    imgs: Dict[int, colmap.ColmapImage] = {}
    for i, (name, w2c) in enumerate(images):
        imgs[i + 1] = colmap.ColmapImage(i + 1, colmap.rotmat2qvec(w2c[:3, :3]), w2c[:3, 3].copy(),
                                         camera.id, name)
    if binary:
        colmap.write_cameras_binary(os.path.join(sparse, "cameras.bin"), {camera.id: camera})
        colmap.write_images_binary(os.path.join(sparse, "images.bin"), imgs)
        colmap.write_points3D_binary(os.path.join(sparse, "points3D.bin"), xyz, rgb)
    else:
        colmap.write_cameras_text(os.path.join(sparse, "cameras.txt"), {camera.id: camera})
        colmap.write_images_text(os.path.join(sparse, "images.txt"), imgs)
        colmap.write_points3D_text(os.path.join(sparse, "points3D.txt"), xyz, rgb)


def pinhole(width: int, height: int, fovx: float) -> colmap.ColmapCamera:
    focal = fov2focal(fovx, width)
    return colmap.ColmapCamera(1, "PINHOLE", width, height,
                               np.array([focal, focal, width / 2, height / 2]))


def blender_to_colmap(src: str, dst: str, binary: bool = True,
                      composited: Optional[Dict[str, np.ndarray]] = None) -> int:
    """Write a COLMAP copy of the Blender scene `src` into `dst`, its
    images composited on black; returns the number of images.
    `composited` may hold those images already, by COLMAP name
    (`<split>_<stem>`), to spare decoding them again."""
    os.makedirs(os.path.join(dst, "images"), exist_ok=True)
    images, size, fovx = [], None, None
    for split in ("train", "test"):
        if not os.path.exists(os.path.join(src, f"transforms_{split}.json")):
            continue
        fovx, poses = blender_poses(src, split)
        for stem, w2c in poses:
            name = f"{split}_{stem}.png"
            image = (composited[name[:-4]] if composited is not None else
                     composite_background(decode_image(os.path.join(src, split, stem + ".png")), False))
            write_png(os.path.join(dst, "images", name), image)
            images.append((name, w2c))
            size = (image.shape[1], image.shape[0])
    xyz, rgb = point_cloud_u8(os.path.join(src, "points3d.ply"))
    write_sparse(dst, pinhole(size[0], size[1], fovx), images, xyz, rgb, binary)
    return len(images)


def view_camera(w2c: np.ndarray, fovx: float, width: int, height: int, device) -> Camera:
    fovy = focal2fov(fov2focal(fovx, width), height)
    return Camera.from_Rt(w2c[:3, :3].T, w2c[:3, 3], fovx, fovy, width, height, device=device)


def capture_scene(model: GaussianModel, poses: Sequence[Pose], dst: str, width: int, height: int,
                  fovx: float, sh_degree: int, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Render `model` at each (stem, w2c) into `dst/images/<stem>.png` and
    write a COLMAP scene of those views with the points (xyz, rgb)."""
    os.makedirs(os.path.join(dst, "images"), exist_ok=True)
    bg = torch.zeros(3, device=model.device)
    images = []
    for stem, w2c in poses:
        cam = view_camera(w2c, fovx, width, height, model.device)
        save_png(os.path.join(dst, "images", stem + ".png"), eval_render(model, cam, bg, sh_degree, "tiled"))
        images.append((stem + ".png", w2c))
    write_sparse(dst, pinhole(width, height, fovx), images, xyz, rgb)


def write_glb(path: str, vertices: np.ndarray, faces: np.ndarray) -> None:
    """One mesh of one triangle primitive: POSITION float32 VEC3 and uint32
    indices, in a single node."""
    pos = np.asarray(vertices, np.float32).tobytes()
    idx = np.asarray(faces, np.uint32).reshape(-1).tobytes()
    blob = pos + idx
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0}, "indices": 1, "mode": 4}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(vertices), "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": 3 * len(faces), "type": "SCALAR"},
        ],
        "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": len(pos)},
                        {"buffer": 0, "byteOffset": len(pos), "byteLength": len(idx)}],
        "buffers": [{"byteLength": len(blob)}],
    }
    js = json.dumps(gltf).encode()
    js += b" " * ((-len(js)) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A))
        f.write(js)
        f.write(struct.pack("<II", len(blob), 0x004E4942))
        f.write(blob)


def zero123_scene(model: GaussianModel, poses: Sequence[Pose], dst: str, size: int,
                  sh_degree: int) -> str:
    """Write a Zero123-layout scene of `model` seen from `poses` into `dst`
    (`%03d.png` RGBA views and `%03d.npy` poses) and its GLB; returns the
    GLB's path (the training CLI's --obj_path)."""
    os.makedirs(dst, exist_ok=True)
    fov = focal2fov(ZERO123_FOCAL_MM, ZERO123_SENSOR_MM)
    black = torch.zeros(3, device=model.device)
    white = torch.ones(3, device=model.device)
    for i, (_, w2c) in enumerate(poses):
        cam = view_camera(w2c, fov, size, size, model.device)
        on_black = eval_render(model, cam, black, sh_degree, "tiled")
        alpha = (1.0 - (eval_render(model, cam, white, sh_degree, "tiled") - on_black)[0]).clamp(0.0, 1.0)
        rgb = on_black / alpha.clamp_min(1e-6)[None]
        rgba = np.concatenate([quantize(rgb), quantize(alpha[None])], axis=2)
        write_png(os.path.join(dst, f"{i:03d}.png"), rgba)
        rt = w2c[:3, :4].copy()
        rt[1:3, :3] *= -1  # the reader negates these rows back
        rt[:3, 3] = -w2c[:3, 3]  # and takes T = -t
        np.save(os.path.join(dst, f"{i:03d}.npy"), rt)

    # one small triangle centred on each of up to GLB_FACES Gaussians; the
    # reader maps a centroid c to swap(c * scale + offset) with y negated
    xyz = model.compact_arrays()["xyz"].astype(np.float64)
    rng = np.random.default_rng(0)
    pick = np.sort(rng.choice(len(xyz), min(GLB_FACES, len(xyz)), replace=False))
    world = xyz[pick]
    normalized = np.stack([world[:, 0], world[:, 2], -world[:, 1]], axis=1)
    centers = (normalized - np.asarray(GLB_OFFSET)[None]) / GLB_SCALE
    d1, d2 = np.array([1e-3, 0.0, 0.0]), np.array([0.0, 1e-3, 0.0])
    verts = np.stack([centers + d1, centers + d2, centers - d1 - d2], axis=1).reshape(-1, 3)
    faces = np.arange(len(verts)).reshape(-1, 3)
    glb = os.path.join(dst, "object.glb")
    write_glb(glb, verts, faces)
    with open(glb.replace(".glb", "_normalization.json"), "w") as f:
        json.dump({"scale": GLB_SCALE, "offset": list(GLB_OFFSET)}, f)
    return glb
