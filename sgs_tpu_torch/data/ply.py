"""PLY reading and writing, byte-compatible with the files the JAX package
writes. Port of `sgs_tpu/data/ply.py`.

Gaussian PLY layout: x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..(3K-4), opacity,
scale_0..2, rot_0..3, all float32 in one binary-little-endian 'vertex'
element. f_dc / f_rest are flattened channel-major.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

_PLY_TO_NP = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """Read every element of a PLY file into {element_name: structured array}.

    Supports binary_little_endian and ascii; list properties raise.
    """
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            header_lines.append(line.decode("ascii", "replace").strip())
            if header_lines[-1] == "end_header":
                break
        if header_lines[0] != "ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # (name, count, [(prop_name, np_dtype), ...])
        for ln in header_lines[1:]:
            parts = ln.split()
            if not parts or parts[0] == "comment":
                continue
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    raise ValueError(f"{path}: list properties unsupported")
                elements[-1][2].append((parts[2], _PLY_TO_NP[parts[1]]))
        if fmt not in ("binary_little_endian", "ascii"):
            raise ValueError(f"{path}: unsupported format {fmt}")

        out = {}
        if fmt == "binary_little_endian":
            for name, count, props in elements:
                dtype = np.dtype(props)
                out[name] = np.frombuffer(
                    f.read(dtype.itemsize * count), dtype=dtype, count=count
                )
        else:
            rest = f.read().decode("ascii").split()
            pos = 0
            for name, count, props in elements:
                width = len(props)
                arr = np.empty(count, dtype=np.dtype(props))
                block = np.array(
                    rest[pos : pos + count * width], dtype=np.float64
                ).reshape(count, width)
                pos += count * width
                for i, (pname, _) in enumerate(props):
                    arr[pname] = block[:, i]
                out[name] = arr
        return out


def _sorted_props(names, prefix: str) -> list:
    return sorted(
        (p for p in names if p.startswith(prefix)), key=lambda s: int(s.split("_")[-1])
    )


def load_gaussian_ply(path: str, max_sh_degree: int) -> Dict[str, np.ndarray]:
    """Gaussian snapshot -> raw parameter arrays (xyz, features_dc (N,1,3),
    features_rest (N,K-1,3), opacity (N,1), scaling (N,3), rotation (N,4)).
    Reads sh-degree-0 files, which carry no f_rest properties."""
    v = read_ply(path)["vertex"]
    n = len(v)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1)
    opacity = np.asarray(v["opacity"])[:, None]
    f_dc = np.zeros((n, 3, 1), np.float32)
    for i in range(3):
        f_dc[:, i, 0] = v[f"f_dc_{i}"]
    rest_names = _sorted_props(v.dtype.names, "f_rest_")
    k = (max_sh_degree + 1) ** 2
    if len(rest_names) != 3 * (k - 1):
        raise ValueError(f"{path}: {len(rest_names)} f_rest channels != 3*({k}-1)")
    if rest_names:
        f_rest = np.stack([v[p] for p in rest_names], axis=1).reshape(n, 3, k - 1)
    else:
        f_rest = np.zeros((n, 3, 0), np.float32)
    scaling = np.stack([v[p] for p in _sorted_props(v.dtype.names, "scale_")], axis=1)
    rotation = np.stack([v[p] for p in _sorted_props(v.dtype.names, "rot")], axis=1)
    return {
        "xyz": xyz.astype(np.float32),
        "features_dc": np.transpose(f_dc, (0, 2, 1)).astype(np.float32),
        "features_rest": np.transpose(f_rest, (0, 2, 1)).astype(np.float32),
        "opacity": opacity.astype(np.float32),
        "scaling": scaling.astype(np.float32),
        "rotation": rotation.astype(np.float32),
    }


def write_ply(path: str, elements: Dict[str, np.ndarray]) -> None:
    """Write {element_name: structured array} as binary little endian."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np_to_ply = {
        ("f", 4): "float", ("f", 8): "double",
        ("i", 4): "int", ("u", 4): "uint",
        ("i", 2): "short", ("u", 2): "ushort",
        ("i", 1): "char", ("u", 1): "uchar",
    }
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        for name, arr in elements.items():
            f.write(f"element {name} {len(arr)}\n".encode())
            for pname in arr.dtype.names:
                dt = arr.dtype[pname]
                f.write(f"property {np_to_ply[(dt.kind, dt.itemsize)]} {pname}\n".encode())
        f.write(b"end_header\n")
        for arr in elements.values():
            f.write(np.ascontiguousarray(arr).astype(arr.dtype.newbyteorder("<")).tobytes())


def gaussian_attribute_names(n_rest: int) -> list:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_gaussian_ply(path: str, xyz: np.ndarray, features_dc: np.ndarray,
                      features_rest: np.ndarray, opacity: np.ndarray, scaling: np.ndarray,
                      rotation: np.ndarray) -> None:
    """Raw parameters (features (N,1,3) and (N,K-1,3), opacity logits,
    log-scales, quaternions) -> a Gaussian snapshot."""
    n = xyz.shape[0]
    n_rest = features_rest.shape[1]
    f_dc = np.transpose(features_dc, (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(features_rest, (0, 2, 1)).reshape(n, -1)
    attrs = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, opacity, scaling, rotation], axis=1
    ).astype(np.float32)
    names = gaussian_attribute_names(n_rest)
    arr = np.empty(n, dtype=[(a, "<f4") for a in names])
    for i, a in enumerate(names):
        arr[a] = attrs[:, i]
    write_ply(path, {"vertex": arr})


def save_point_cloud_ply(path: str, points: np.ndarray, colors_u8: np.ndarray,
                         normals: np.ndarray = None) -> None:
    """xyz, nx, ny, nz as float and red, green, blue as uchar."""
    n = points.shape[0]
    if normals is None:
        normals = np.zeros_like(points)
    dtype = [(a, "<f4") for a in ("x", "y", "z", "nx", "ny", "nz")] + [
        (a, "u1") for a in ("red", "green", "blue")
    ]
    arr = np.empty(n, dtype=dtype)
    for i, a in enumerate(("x", "y", "z")):
        arr[a] = points[:, i]
        arr["n" + a] = normals[:, i]
    for i, a in enumerate(("red", "green", "blue")):
        arr[a] = colors_u8[:, i]
    write_ply(path, {"vertex": arr})


def load_point_cloud_ply(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (points, colours in [0, 1], normals)."""
    v = read_ply(path)["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    names = v.dtype.names or ()
    if "red" in names:
        cols = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.float32) / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in names:
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals
