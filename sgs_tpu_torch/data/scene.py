"""Scene: the cameras, the scene extent and the initial Gaussians of a
dataset. Port of `sgs_tpu/data/scene.py`.

In the JAX package's order: the scene type from its marker file
(`mesh3d.ply`: a mesh scene, which raises without an obj_path as JAX's
does; `000.npy`: Zero123 with `obj_path` and `mesh_max_faces`; `sparse`:
COLMAP with `images`; `transforms_train.json`: Blender; anything else
raises), input.ply and cameras.json written into the model directory
unless a trained iteration is loaded, train and test lists shuffled with
the global `random` (the training CLI seeds it) unless `shuffle` is
False, the extent from the NeRF++ normalisation radius, the cameras
loaded at `resolution` (`camera_utils.load_cam`), and the pool either
loaded from point_cloud/iteration_<load_iteration>/point_cloud.ply (-1:
the latest) or built from the scene's point cloud. With
`downsample_init` d != 1 the init cloud is first cut to round(n / d)
points drawn by `np.random.choice(n, ..., replace=False)` from the global
numpy state, as the JAX Scene draws them (the CLIs seed it), and
`init_pcd` holds the cloud the pool was built from. `scene_info` keeps
what the reader returned.
"""

from __future__ import annotations

import json
import os
import random
import shutil
from typing import List, Optional

import numpy as np
import torch

from sgs_tpu_torch.data import ply as ply_io
from sgs_tpu_torch.data.camera_utils import LoadedCamera, camera_list_from_infos, camera_to_json
from sgs_tpu_torch.data.readers import (
    PointCloud,
    SceneInfo,
    read_colmap_scene,
    read_mesh_scene,
    read_nerf_synthetic_scene,
)
from sgs_tpu_torch.models.gaussians import GaussianModel


def search_for_max_iteration(folder: str) -> Optional[int]:
    if not os.path.isdir(folder):
        return None
    iters = [int(name.split("_")[-1]) for name in os.listdir(folder) if name.startswith("iteration_")]
    return max(iters) if iters else None


def read_scene(args, device: "str | torch.device" = "cuda") -> SceneInfo:
    """The reader that the source directory's marker file selects, decoding
    for `device`."""
    src = args.source_path
    if os.path.exists(os.path.join(src, "mesh3d.ply")):
        return read_mesh_scene(src, args.white_background, args.eval,
                               decimate_factor=args.decimate_factor, device=device)
    if os.path.exists(os.path.join(src, "000.npy")):
        return read_mesh_scene(src, args.white_background, args.eval, obj_path=args.obj_path,
                               mesh_max_faces=args.mesh_max_faces, device=device)
    if os.path.exists(os.path.join(src, "sparse")):
        return read_colmap_scene(src, args.images, args.eval, device=device)
    if os.path.exists(os.path.join(src, "transforms_train.json")):
        return read_nerf_synthetic_scene(src, args.white_background, args.eval, device=device)
    raise ValueError(f"Could not recognize scene type in {src}!")


class Scene:
    """`ply_path`, which the JAX Scene lacks, loads that PLY as the trained
    model in place of the model directory's (the render CLI's --ply)."""

    def __init__(self, model_params, load_iteration: Optional[int] = None, shuffle: bool = True,
                 device: "str | torch.device" = "cuda", ply_path: Optional[str] = None,
                 downsample_init: float = 1.0):
        args = model_params
        self.model_path = args.model_path
        self.loaded_iter = None
        if load_iteration:
            if load_iteration == -1:
                self.loaded_iter = search_for_max_iteration(os.path.join(self.model_path, "point_cloud"))
            else:
                self.loaded_iter = load_iteration
            print(f"Loading trained model at iteration {self.loaded_iter}")
        scene_info = read_scene(args, device)
        self.scene_info = scene_info

        if not self.loaded_iter and self.model_path:
            os.makedirs(self.model_path, exist_ok=True)
            shutil.copyfile(scene_info.ply_path, os.path.join(self.model_path, "input.ply"))
            cams = list(scene_info.test_cameras) + list(scene_info.train_cameras)
            with open(os.path.join(self.model_path, "cameras.json"), "w") as f:
                json.dump([camera_to_json(i, c) for i, c in enumerate(cams)], f)
        if shuffle:
            random.shuffle(scene_info.train_cameras)
            random.shuffle(scene_info.test_cameras)

        self.cameras_extent: float = scene_info.nerf_normalization["radius"]
        self.train_cameras: List[LoadedCamera] = camera_list_from_infos(
            scene_info.train_cameras, 1.0, args.resolution, device)
        self.test_cameras: List[LoadedCamera] = camera_list_from_infos(
            scene_info.test_cameras, 1.0, args.resolution, device)

        if self.loaded_iter or ply_path:
            ply_path = ply_path or os.path.join(
                self.model_path, "point_cloud", f"iteration_{self.loaded_iter}", "point_cloud.ply")
            self.pool = GaussianModel.from_ply(ply_path, args.sh_degree, device)
        else:
            pcd = scene_info.point_cloud
            if pcd is None:
                raise ValueError("scene has no initial point cloud")
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
