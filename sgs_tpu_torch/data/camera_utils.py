"""CameraInfo -> render camera + ground-truth image, with the JAX
package's resolution policy, and the camera JSON dump. Port of
`sgs_tpu/data/camera_utils.py`, with `data/resize.py` (equal to PIL's
`Image.resize` bit for bit) in place of PIL.

`load_cam`'s target size, for an image of orig_w x orig_h:
- `resolution` 1, 2, 4 or 8: round(orig / (scale * resolution)) with
  Python's `round`;
- -1: the image as it is, unless it is wider than 1,600 px: then it is
  brought to 1,600 px wide (the INFO line is printed once per process);
- any other value: that width, the height in proportion;
- the last two take int(orig / scale) of each side.
The GT is the resized image as float32 / 255 clipped to [0, 1], its RGB
times its alpha when it has four channels. A gray image keeps one channel,
as the JAX package's does (the losses broadcast it).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from sgs_tpu_torch.core.camera import Camera
from sgs_tpu_torch.core.projection import fov2focal
from sgs_tpu_torch.data.readers import CameraInfo, read_cameras_from_transforms
from sgs_tpu_torch.data.resize import resize

MAX_WIDTH = 1600
LARGE_IMAGE_INFO = ("[ INFO ] Encountered quite large input images (>1.6K pixels width), "
                    "rescaling to 1.6K.")
_warned = {"large": False}


@dataclass
class LoadedCamera:
    """A render camera paired with its ground-truth image. `uid` is the
    index in its list, `colmap_id` the CameraInfo's uid."""

    camera: Camera
    gt_image: torch.Tensor  # (3, H, W) float32 in [0, 1]; (1, H, W) for a gray image
    image_name: str
    uid: int
    colmap_id: int


def target_size(resolution_arg: int, orig_w: int, orig_h: int, resolution_scale: float = 1.0):
    """(width, height) that `load_cam` resizes an orig_w x orig_h image to."""
    if resolution_arg in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution_arg)),
                round(orig_h / (resolution_scale * resolution_arg)))
    if resolution_arg == -1:
        if orig_w > MAX_WIDTH:
            if not _warned["large"]:
                print(LARGE_IMAGE_INFO)
                _warned["large"] = True
            global_down = orig_w / MAX_WIDTH
        else:
            global_down = 1
    else:
        global_down = orig_w / resolution_arg
    scale = float(global_down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def gt_from_image(image: np.ndarray, size) -> np.ndarray:
    """(C, h, w) float32 GT of an (H, W, C) uint8 image resized to `size`
    (width, height), as the JAX package's `pil_to_chw` and `load_cam`."""
    if image.shape[2] == 2:
        raise ValueError("gray-alpha images are not supported: the JAX package's GT keeps both "
                         "channels and its losses cannot broadcast them against RGB")
    arr = resize(image, size).astype(np.float32) / 255.0
    chw = arr.transpose(2, 0, 1)
    gt = np.clip(chw[:3], 0.0, 1.0)
    if chw.shape[0] == 4:
        gt = gt * chw[3:4]
    return np.ascontiguousarray(gt, dtype=np.float32)


def load_cam(resolution_arg: int, uid: int, info: CameraInfo, resolution_scale: float = 1.0,
             device: "str | torch.device" = "cuda") -> LoadedCamera:
    orig_h, orig_w = info.image.shape[:2]
    size = target_size(resolution_arg, orig_w, orig_h, resolution_scale)
    gt = gt_from_image(info.image, size)
    cam = Camera.from_Rt(info.R, info.T, info.FovX, info.FovY, size[0], size[1], device=device)
    return LoadedCamera(camera=cam, gt_image=torch.from_numpy(gt).to(cam.world_view_transform.device),
                        image_name=info.image_name, uid=uid, colmap_id=info.uid)


def camera_list_from_infos(infos: List[CameraInfo], resolution_scale: float, resolution_arg: int,
                           device: "str | torch.device" = "cuda") -> List[LoadedCamera]:
    return [load_cam(resolution_arg, i, c, resolution_scale, device) for i, c in enumerate(infos)]


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


def read_nerf_synthetic_split(path: str, split: str, white_background: bool, resolution: int = -1,
                              device: "str | torch.device" = "cuda") -> List[LoadedCamera]:
    """Load `transforms_<split>.json` of a NeRF-synthetic scene as cameras."""
    infos = read_cameras_from_transforms(path, f"transforms_{split}.json", white_background)
    return camera_list_from_infos(infos, 1.0, resolution, device)
