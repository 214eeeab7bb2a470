"""Scene: the cameras, the scene extent and the initial Gaussians of a
Blender (NeRF-synthetic) dataset. Port of the Blender branch of
`sgs_tpu/data/scene.py` and its reader (`read_nerf_synthetic_scene`).

In the JAX package's order: cameras read (the test views merged into
train when `eval` is False), input.ply and cameras.json written into the
model directory unless a trained iteration is loaded, train and test
lists shuffled with the global `random` (the training CLI seeds it)
unless `shuffle` is False, the extent from the NeRF++ normalisation
radius, and the pool either loaded from
point_cloud/iteration_<load_iteration>/point_cloud.ply (-1: the latest)
or built from points3d.ply (a random 100k-point cloud is written first
when the scene has none). With `downsample_init` d != 1 the init cloud is
first cut to round(n / d) points drawn by `np.random.choice(n, ...,
replace=False)` from the global numpy state, as the JAX Scene draws
them (the CLIs seed it), and `init_pcd` holds the cloud the pool was
built from. COLMAP and mesh scenes are not ported yet and raise.
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from sgs_tpu_torch.core.projection import fov2focal, world_to_view
from sgs_tpu_torch.core.sh import C0
from sgs_tpu_torch.data import ply as ply_io
from sgs_tpu_torch.data.readers import CameraInfo, LoadedCamera, load_camera, read_cameras_from_transforms
from sgs_tpu_torch.models.gaussians import GaussianModel


class PointCloud(NamedTuple):
    points: np.ndarray
    colors: np.ndarray
    normals: np.ndarray


def get_nerfpp_norm(cam_infos: List[CameraInfo]) -> dict:
    centers = np.stack([np.linalg.inv(world_to_view(c.R, c.T))[:3, 3] for c in cam_infos])
    avg = centers.mean(axis=0)
    diagonal = float(np.max(np.linalg.norm(centers - avg, axis=1)))
    return {"translate": -avg, "radius": diagonal * 1.1}


def camera_to_json(idx: int, cam: CameraInfo) -> dict:
    rt = np.zeros((4, 4))
    rt[:3, :3] = cam.R.T
    rt[:3, 3] = cam.T
    rt[3, 3] = 1.0
    w2c = np.linalg.inv(rt)
    return {
        "id": idx,
        "img_name": cam.image_name,
        "width": cam.width,
        "height": cam.height,
        "position": w2c[:3, 3].tolist(),
        "rotation": [r.tolist() for r in w2c[:3, :3]],
        "fy": fov2focal(cam.FovY, cam.height),
        "fx": fov2focal(cam.FovX, cam.width),
    }


def _point_cloud(path: str):
    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3
        shs = np.random.random((num_pts, 3)) / 255.0
        rgb = shs.astype(np.float32) * np.float32(C0) + np.float32(0.5)
        ply_io.save_point_cloud_ply(ply_path, xyz.astype(np.float32), (rgb * 255).astype(np.uint8))
    return ply_path, ply_io.load_point_cloud_ply(ply_path)


def search_for_max_iteration(folder: str) -> Optional[int]:
    if not os.path.isdir(folder):
        return None
    iters = [int(name.split("_")[-1]) for name in os.listdir(folder) if name.startswith("iteration_")]
    return max(iters) if iters else None


class Scene:
    """`ply_path`, which the JAX Scene lacks, loads that PLY as the trained
    model in place of the model directory's (the render CLI's --ply)."""

    def __init__(self, model_params, load_iteration: Optional[int] = None, shuffle: bool = True,
                 device: "str | torch.device" = "cuda", ply_path: Optional[str] = None,
                 downsample_init: float = 1.0):
        args = model_params
        src = args.source_path
        self.model_path = args.model_path
        self.loaded_iter = None
        if load_iteration:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")
        if not os.path.exists(os.path.join(src, "transforms_train.json")):
            raise NotImplementedError(
                f"{src}: only Blender (transforms_train.json) scenes are ported"
            )
        train = read_cameras_from_transforms(src, "transforms_train.json", args.white_background)
        test = (
            read_cameras_from_transforms(src, "transforms_test.json", args.white_background)
            if os.path.exists(os.path.join(src, "transforms_test.json")) else []
        )
        if not args.eval:
            train, test = train + test, []
        norm = get_nerfpp_norm(train)
        input_ply, cloud = _point_cloud(src)

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(input_ply, os.path.join(self.model_path, "input.ply"))
            cams = list(test) + list(train)
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)
        if shuffle:
            random.shuffle(train)
            random.shuffle(test)

        self.cameras_extent: float = norm["radius"]
        self.train_cameras: List[LoadedCamera] = [load_camera(c, args.resolution, device) for c in train]
        self.test_cameras: List[LoadedCamera] = [load_camera(c, args.resolution, device) for c in test]

        if self.loaded_iter or ply_path:
            ply_path = ply_path or os.path.join(
                self.model_path, "point_cloud", f"iteration_{self.loaded_iter}", "point_cloud.ply")
            self.pool = GaussianModel.from_ply(ply_path, args.sh_degree, device)
        else:
            pcd = PointCloud(*cloud)
            if downsample_init != 1.0:
                num = round(len(pcd.points) / downsample_init)
                idx = np.random.choice(len(pcd.points), num, replace=False)
                pcd = PointCloud(pcd.points[idx], pcd.colors[idx], pcd.normals[idx])
            self.init_pcd = pcd
            print(f"Number of points at initialisation : {len(pcd.points)}")
            self.pool = GaussianModel.from_pcd(pcd.points, pcd.colors, args.sh_degree, device=device)

    def save(self, model: GaussianModel, iteration: int) -> str:
        path = os.path.join(self.model_path, f"point_cloud/iteration_{iteration}", "point_cloud.ply")
        a = model.compact_arrays()
        ply_io.save_gaussian_ply(path, a["xyz"], a["features_dc"], a["features_rest"],
                                 a["opacity"], a["scaling"], a["rotation"])
        return path

    def getTrainCameras(self) -> List[LoadedCamera]:
        return self.train_cameras

    def getTestCameras(self) -> List[LoadedCamera]:
        return self.test_cameras
