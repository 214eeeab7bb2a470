"""COLMAP sparse-reconstruction files (binary and text). Port of
`sgs_tpu/data/colmap.py`, which imports no JAX; the port keeps its own
copy so that it imports nothing of `sgs_tpu`.

Cameras, images (extrinsics, without their 2D points) and points3D, read
from the binary layouts of the COLMAP format or its text form; the three
binary writers, and three text writers beside them. `qvec2rotmat` and
`rotmat2qvec` convert between a w2c rotation and COLMAP's (w, x, y, z)
quaternion.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

CAMERA_MODEL_PARAMS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODEL_PARAMS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) wxyz
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    Rxx, Ryx, Rzx, Rxy, Ryy, Rzy, Rxz, Ryz, Rzz = R.flat
    K = (
        np.array(
            [
                [Rxx - Ryy - Rzz, 0, 0, 0],
                [Ryx + Rxy, Ryy - Rxx - Rzz, 0, 0],
                [Rzx + Rxz, Rzy + Ryz, Rzz - Rxx - Ryy, 0],
                [Ryz - Rzy, Rzx - Rxz, Rxy - Ryx, Rxx + Ryy + Rzz],
            ]
        )
        / 3.0
    )
    eigvals, eigvecs = np.linalg.eigh(K)
    qvec = eigvecs[[3, 0, 1, 2], np.argmax(eigvals)]
    if qvec[0] < 0:
        qvec *= -1
    return qvec


# ------------------------------------------------------------------ binary

def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cam_id, model_id, width, height = struct.unpack("<iiQQ", f.read(24))
            name, n_params = CAMERA_MODEL_PARAMS[model_id]
            params = np.frombuffer(f.read(8 * n_params), dtype="<f8")
            cams[cam_id] = ColmapCamera(cam_id, name, int(width), int(height), params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            image_id = struct.unpack("<i", f.read(4))[0]
            qt = np.frombuffer(f.read(56), dtype="<f8")
            camera_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts2d,) = struct.unpack("<Q", f.read(8))
            f.seek(24 * n_pts2d, 1)  # skip (x, y, point3D_id) tuples
            imgs[image_id] = ColmapImage(
                image_id, qt[:4].copy(), qt[4:7].copy(), camera_id, name.decode()
            )
    return imgs


def read_points3D_binary(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz (N,3) f64, rgb (N,3) u8-as-f64, error (N,1))."""
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<Q", buf, 0)
    xyzs = np.empty((n, 3))
    rgbs = np.empty((n, 3))
    errors = np.empty((n, 1))
    off = 8
    for i in range(n):
        # id(Q) xyz(3d) rgb(3B) error(d) track_len(Q)
        xyzs[i] = np.frombuffer(buf, "<f8", 3, off + 8)
        rgbs[i] = np.frombuffer(buf, "u1", 3, off + 32)
        errors[i] = struct.unpack_from("<d", buf, off + 35)[0]
        (track_len,) = struct.unpack_from("<Q", buf, off + 43)
        off += 51 + 8 * track_len
    return xyzs, rgbs, errors


# -------------------------------------------------------------------- text

def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            cams[int(e[0])] = ColmapCamera(
                int(e[0]), e[1], int(e[2]), int(e[3]),
                np.array(list(map(float, e[4:]))),
            )
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]
    # alternating: image line, points2D line
    for ln in lines[0::2]:
        e = ln.split()
        imgs[int(e[0])] = ColmapImage(
            int(e[0]),
            np.array(list(map(float, e[1:5]))),
            np.array(list(map(float, e[5:8]))),
            int(e[8]),
            e[9],
        )
    return imgs


def read_points3D_text(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errors = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            xyzs.append(list(map(float, e[1:4])))
            rgbs.append(list(map(int, e[4:7])))
            errors.append([float(e[7])])
    return np.array(xyzs), np.array(rgbs), np.array(errors)


# ------------------------------------------------------------------ writers
# (used by the tests and `tools/colmap_scene.py`)

def write_cameras_binary(path: str, cams: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(np.asarray(cam.params, "<f8").tobytes())


def write_images_binary(path: str, imgs: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(np.asarray(im.qvec, "<f8").tobytes())
            f.write(np.asarray(im.tvec, "<f8").tobytes())
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D points


def write_points3D_binary(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q", i + 1))
            f.write(np.asarray(xyz[i], "<f8").tobytes())
            f.write(np.asarray(rgb[i], "u1").tobytes())
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))


# The text form, with every float written by `repr` (read back exactly).
# Each image gets one 2D point line holding a single observation with no
# 3D point (POINT3D_ID -1): `read_images_text` drops empty lines, so an
# empty points line would pair each image line with the next image's.

def write_cameras_text(path: str, cams: Dict[int, ColmapCamera]) -> None:
    with open(path, "w") as f:
        f.write("# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for cam in cams.values():
            params = " ".join(repr(float(p)) for p in cam.params)
            f.write(f"{cam.id} {cam.model} {cam.width} {cam.height} {params}\n")


def write_images_text(path: str, imgs: Dict[int, ColmapImage]) -> None:
    with open(path, "w") as f:
        f.write("# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("# POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for im in imgs.values():
            pose = " ".join(repr(float(v)) for v in (*im.qvec, *im.tvec))
            f.write(f"{im.id} {pose} {im.camera_id} {im.name}\n0.0 0.0 -1\n")


def write_points3D_text(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write("# POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n")
        for i in range(len(xyz)):
            pos = " ".join(repr(float(v)) for v in xyz[i])
            col = " ".join(str(int(c)) for c in rgb[i])
            f.write(f"{i + 1} {pos} {col} 0.0\n")
