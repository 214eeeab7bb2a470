"""Blender / NeRF-synthetic scene reader. Port of the Blender half of
`sgs_tpu/data/readers.py` and the `resolution=-1` case of
`sgs_tpu/data/camera_utils.py`, with the PNG codec of `png.py` in place
of PIL.

Conventions: CameraInfo.R is the camera-to-world rotation, T the
world-to-view translation; Blender transforms get the OpenGL -> COLMAP
axis flip; alpha images are composited onto the background and truncated
to bytes in float64 exactly as the JAX reader does.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import focal2fov, fov2focal
from sgs_tpu_torch.data.png import read_png


@dataclass
class CameraInfo:
    uid: int
    R: np.ndarray  # (3,3) camera-to-world rotation
    T: np.ndarray  # (3,) world-to-view translation
    FovY: float
    FovX: float
    image: np.ndarray  # (H, W, 3) uint8, composited
    image_path: str
    image_name: str
    width: int
    height: int


@dataclass
class LoadedCamera:
    """A render camera paired with its ground-truth image."""

    camera: Camera
    gt_image: torch.Tensor  # (3, H, W) float32 in [0, 1]
    image_name: str
    uid: int


def _to_rgba(image: np.ndarray) -> np.ndarray:
    """(H, W, C) uint8 with C in 1..4 -> (H, W, 4), as PIL's convert("RGBA")."""
    c = image.shape[2]
    if c == 4:
        return image
    opaque = np.full(image.shape[:2] + (1,), 255, np.uint8)
    if c == 3:
        return np.concatenate([image, opaque], axis=2)
    gray = np.repeat(image[:, :, :1], 3, axis=2)
    alpha = image[:, :, 1:2] if c == 2 else opaque
    return np.concatenate([gray, alpha], axis=2)


def composite_background(image: np.ndarray, white_background: bool) -> np.ndarray:
    """Alpha-composite onto black or white and truncate to uint8 RGB."""
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
        image = composite_background(read_png(cam_name), white_background)
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


def load_camera(info: CameraInfo, resolution: int = -1,
                device: "str | torch.device" = "cuda") -> LoadedCamera:
    """CameraInfo -> render camera + GT image at the stored resolution.

    Only `resolution=-1` with images at most 1600 px wide is ported: that
    case keeps the image as it is. Every other case raises.
    """
    if resolution != -1 or info.width > 1600:
        raise NotImplementedError(
            "only resolution=-1 with images <= 1600 px wide is ported "
            f"(got resolution={resolution}, width={info.width})"
        )
    cam = Camera.from_Rt(
        info.R, info.T, info.FovX, info.FovY, info.width, info.height, device=device
    )
    chw = torch.from_numpy(info.image).to(torch.float32).permute(2, 0, 1) / 255.0
    gt = chw.clamp(0.0, 1.0).contiguous().to(cam.world_view_transform.device)
    return LoadedCamera(camera=cam, gt_image=gt, image_name=info.image_name, uid=info.uid)


def read_nerf_synthetic_split(
    path: str, split: str, white_background: bool, resolution: int = -1,
    device: "str | torch.device" = "cuda",
) -> List[LoadedCamera]:
    """Load `transforms_<split>.json` of a NeRF-synthetic scene as cameras."""
    infos = read_cameras_from_transforms(path, f"transforms_{split}.json", white_background)
    return [load_camera(info, resolution, device) for info in infos]
