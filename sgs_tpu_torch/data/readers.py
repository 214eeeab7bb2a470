"""Dataset readers: COLMAP, Blender (NeRF-synthetic), Zero123 and mesh
scenes. Port of `sgs_tpu/data/readers.py`, with the PNG codec of `png.py`
in place of PIL.

Conventions, as the JAX package's:
- CameraInfo.R is the camera-to-world rotation (the w2c rotation
  transposed), T the world-to-view translation; `image` is the decoded
  (H, W, C) uint8 image;
- COLMAP: `sparse/0` (else `sparse`), binary files (else text); PINHOLE,
  SIMPLE_PINHOLE and OPENCV cameras (OPENCV's distortion ignored); uid the
  camera id; sorted by image name; the eval split takes every
  llffhold-th view; `points3D.ply` is written into the sparse directory
  from points3D.bin (else .txt) when it is missing; images are not
  composited;
- Blender: the OpenGL -> COLMAP axis flip; alpha composited onto the
  background and truncated to bytes in float64; a random 100k-point
  cloud in [-1.3, 1.3]^3 is written when the scene has none;
- Zero123: the first 10 images are the train split, the rest the test
  split; `[R|T]` .npy poses with the rows 1 and 2 negated, T = -t; the
  35 mm / 32 mm intrinsics; alpha composited as Blender;
- mesh: triangle centroids of the GLB (`mesh.py`), `mesh_max_faces` as a
  guard, the paired `*_normalization.json` scale and offset, then the
  [0, 2, 1] axis swap with y negated; colours drawn with
  `np.random.random` from the global state (the CLIs seed it);
- the scene extent is 1.1 x the largest distance of a train camera centre
  from their mean (NeRF++ normalisation).

Only PNG decodes: a JPEG, palette or 16-bit image raises an error that
names the file and its format.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List, NamedTuple, Optional

import numpy as np

from sgs_tpu_torch.core.projection import focal2fov, fov2focal, world_to_view
from sgs_tpu_torch.core.sh import C0
from sgs_tpu_torch.data import colmap
from sgs_tpu_torch.data.mesh import load_mesh_triangle_centroids
from sgs_tpu_torch.data.ply import load_point_cloud_ply, save_point_cloud_ply
from sgs_tpu_torch.data.png import read_png

_JPEG_MAGIC = b"\xff\xd8\xff"


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # (3,3) camera-to-world rotation
    T: np.ndarray  # (3,) world-to-view translation
    FovY: float
    FovX: float
    image: np.ndarray  # (H, W, C) uint8
    image_path: str
    image_name: str
    width: int
    height: int


class PointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


@dataclass
class SceneInfo:
    point_cloud: Optional[PointCloud]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    nerf_normalization: dict
    ply_path: str


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    centers = np.stack([np.linalg.inv(world_to_view(c.R, c.T))[:3, 3] for c in cam_infos])
    avg = centers.mean(axis=0)
    diagonal = float(np.max(np.linalg.norm(centers - avg, axis=1)))
    return {"translate": -avg, "radius": diagonal * 1.1}


def decode_image(path: str) -> np.ndarray:
    """(H, W, C) uint8 of a PNG file; any other format raises."""
    with open(path, "rb") as f:
        head = f.read(3)
    if head == _JPEG_MAGIC:
        raise ValueError(f"{path}: JPEG image; the port decodes PNG only (there is no PIL on the "
                         "card), so convert the images to PNG")
    return read_png(path)


def sh_to_rgb(shs: np.ndarray) -> np.ndarray:
    """The JAX package's `sh_to_rgb` on float32 input: sh * C0 + 0.5."""
    return shs.astype(np.float32) * np.float32(C0) + np.float32(0.5)


def _fetch_ply(path: str) -> Optional[PointCloud]:
    try:
        return PointCloud(*load_point_cloud_ply(path))
    except (OSError, ValueError, KeyError):
        return None


# ------------------------------------------------------------------- COLMAP

def read_colmap_scene(path: str, images: Optional[str], eval_split: bool,
                      llffhold: int = 8) -> SceneInfo:
    sparse = os.path.join(path, "sparse/0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(path, "sparse")
    try:
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    except FileNotFoundError:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    reading_dir = images if images else "images"
    cam_infos = []
    for key in extr:
        im = extr[key]
        cam = intr[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            fx = fy = cam.params[0]
        elif cam.model in ("PINHOLE", "OPENCV"):
            # OPENCV: the distortion coefficients are ignored, as in JAX
            fx, fy = cam.params[0], cam.params[1]
        else:
            raise ValueError(
                f"Colmap camera model {cam.model} not handled: only "
                "undistorted datasets (PINHOLE or SIMPLE_PINHOLE) supported"
            )
        image_path = os.path.join(path, reading_dir, os.path.basename(im.name))
        cam_infos.append(CameraInfo(
            uid=cam.id, R=colmap.qvec2rotmat(im.qvec).T, T=np.array(im.tvec),
            FovY=focal2fov(fy, cam.height), FovX=focal2fov(fx, cam.width),
            image=decode_image(image_path), image_path=image_path,
            image_name=os.path.basename(image_path).split(".")[0],
            width=cam.width, height=cam.height,
        ))
    cam_infos.sort(key=lambda c: c.image_name)

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(cam_infos) if i % llffhold == 0]
    else:
        train, test = cam_infos, []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        try:
            xyz, rgb, _ = colmap.read_points3D_binary(os.path.join(sparse, "points3D.bin"))
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3D_text(os.path.join(sparse, "points3D.txt"))
        save_point_cloud_ply(ply_path, xyz.astype(np.float32), rgb.astype(np.uint8))
    return SceneInfo(_fetch_ply(ply_path), train, test, norm, ply_path)


# ------------------------------------------------------------------ Blender

def _to_rgba(image: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 with C in 1, 2 or 4 -> (H, W, 4), as PIL's convert("RGBA")."""
    c = image.shape[2]
    if c == 4:
        return image
    opaque = np.full(image.shape[:2] + (1,), 255, np.uint8)
    gray = np.repeat(image[:, :, :1], 3, axis=2)
    alpha = image[:, :, 1:2] if c == 2 else opaque
    return np.concatenate([gray, alpha], axis=2)


def composite_background(image: np.ndarray, white_background: bool) -> np.ndarray:
    """Alpha-composite onto black or white and truncate to uint8 RGB."""
    if image.shape[2] == 3:
        # alpha 1: (v / 255) * 255 truncates back to v for every byte
        return image.copy()
    data = _to_rgba(image).astype(np.float64) / 255.0
    bg = np.array([1.0, 1.0, 1.0]) if white_background else np.array([0.0, 0.0, 0.0])
    rgb = data[:, :, :3] * data[:, :, 3:4] + bg * (1 - data[:, :, 3:4])
    return (rgb * 255.0).astype(np.uint8)


def read_cameras_from_transforms(
    path: str, transformsfile: str, white_background: bool, extension: str = ".png"
) -> List[CameraInfo]:
    cam_infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        file_path = frame["file_path"]
        cam_name = os.path.join(path, file_path + extension)
        if not os.path.exists(cam_name) and os.path.exists(os.path.join(path, file_path)):
            cam_name = os.path.join(path, file_path)
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL/Blender -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]
        image = composite_background(decode_image(cam_name), white_background)
        height, width = image.shape[:2]
        fovy = focal2fov(fov2focal(fovx, width), height)
        cam_infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, FovY=fovy, FovX=fovx, image=image,
                image_path=cam_name, image_name=Path(cam_name).stem,
                width=width, height=height,
            )
        )
    return cam_infos


def read_nerf_synthetic_scene(path: str, white_background: bool, eval_split: bool,
                              extension: str = ".png") -> SceneInfo:
    train = read_cameras_from_transforms(path, "transforms_train.json", white_background, extension)
    test = (
        read_cameras_from_transforms(path, "transforms_test.json", white_background, extension)
        if os.path.exists(os.path.join(path, "transforms_test.json")) else []
    )
    if not eval_split:
        train, test = train + test, []
    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        rgb = sh_to_rgb(shs)
        save_point_cloud_ply(ply_path, xyz.astype(np.float32), (rgb * 255).astype(np.uint8))
    return SceneInfo(_fetch_ply(ply_path), train, test, norm, ply_path)


# ------------------------------------------------------------------ Zero123

ZERO123_TRAIN_VIEWS = 10
ZERO123_FOCAL_MM, ZERO123_SENSOR_MM = 35, 32  # Blender's default lens


def read_cameras_from_zero123(path: str, white_background: bool, extension: str = ".png",
                              train_split: bool = True) -> List[CameraInfo]:
    image_files = sorted(glob.glob(os.path.join(path, "*" + extension)))
    image_files = (image_files[:ZERO123_TRAIN_VIEWS] if train_split
                   else image_files[ZERO123_TRAIN_VIEWS:])
    cam_infos = []
    for idx, frame_path in enumerate(image_files):
        w2c = np.array(np.load(frame_path.replace(extension, ".npy")), dtype=np.float64)
        w2c[1:3, :3] *= -1  # Blender -> COLMAP rows
        R = w2c[:3, :3].T
        T = -w2c[:3, 3]
        image = composite_background(decode_image(frame_path), white_background)
        height, width = image.shape[:2]
        fov = focal2fov(ZERO123_FOCAL_MM, ZERO123_SENSOR_MM)
        cam_infos.append(
            CameraInfo(
                uid=idx, R=R, T=T, FovY=fov, FovX=fov, image=image,
                image_path=frame_path, image_name=Path(frame_path).stem,
                width=width, height=height,
            )
        )
    return cam_infos


def read_mesh_scene(path: str, white_background: bool, eval_split: bool,
                    obj_path: Optional[str] = None, extension: str = ".png",
                    decimate_factor: float = 1.0, mesh_max_faces: int = -1) -> SceneInfo:
    """Zero123 scene: init points at the mesh's triangle centroids."""
    if obj_path is None:
        raise NotImplementedError("non-Zero123 mesh datasets (matching reference)")
    train = read_cameras_from_zero123(path, white_background, extension, True)
    test = read_cameras_from_zero123(path, white_background, extension, False)
    if not eval_split:
        train, test = train + test, []
    norm = get_nerfpp_norm(train)

    mesh_path = obj_path if obj_path else os.path.join(path, "mesh3d.ply")
    xyzs = load_mesh_triangle_centroids(mesh_path, decimate_factor)
    if mesh_max_faces != -1 and len(xyzs) > mesh_max_faces:
        raise RuntimeError(f"mesh has {len(xyzs)} faces > mesh_max_faces={mesh_max_faces}")
    norm_json = (obj_path or mesh_path).replace(".glb", "_normalization.json")
    if os.path.exists(norm_json):
        with open(norm_json) as f:
            nd = json.load(f)
        xyzs = xyzs * float(nd["scale"]) + np.asarray(nd["offset"])[None, :]
    xyzs = xyzs[:, [0, 2, 1]].copy()
    xyzs[:, 1] *= -1

    colors = sh_to_rgb(np.float32(np.random.random((len(xyzs), 3)) / 255.0))
    ply_path = os.path.join(path, "points3d.ply")
    save_point_cloud_ply(ply_path, xyzs.astype(np.float32), (colors * 255).astype(np.uint8))
    pcd = PointCloud(points=xyzs.astype(np.float32), colors=colors, normals=np.zeros_like(xyzs))
    return SceneInfo(pcd, train, test, norm, ply_path)
