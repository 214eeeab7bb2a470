"""PLY reading, byte-compatible with the Gaussian snapshots the JAX package
writes. Port of the reader half of `sgs_tpu/data/ply.py`.

Gaussian PLY layout: x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..(3K-4), opacity,
scale_0..2, rot_0..3, all float32 in one binary-little-endian 'vertex'
element. f_dc / f_rest are flattened channel-major.
"""

from __future__ import annotations

from typing import Dict

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
