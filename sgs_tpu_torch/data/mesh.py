"""Minimal GLB (glTF 2.0 binary) loading for the Zero123/mesh init path.
Port of `sgs_tpu/data/mesh.py`, which imports no JAX; the port keeps its
own copy so that it imports nothing of `sgs_tpu`.

`parse_glb` splits a GLB into its JSON and binary chunks; the accessors
read POSITION and index buffers (strided views included); the node walk
applies each node's matrix or TRS transform down the scene graph; and
`load_mesh_triangle_centroids` returns the triangle centroids, which seed
the Gaussians. `decimate_factor` d keeps int(F / d) centroids evenly
spaced over the F faces (the reference pipeline decimated the mesh to the
same count; only the count matters for the init).
"""

from __future__ import annotations

import json
import struct
from typing import List, Tuple

import numpy as np

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def parse_glb(path: str) -> Tuple[dict, bytes]:
    """Return (gltf json dict, binary chunk bytes)."""
    with open(path, "rb") as f:
        magic, version, _length = struct.unpack("<III", f.read(12))
        if magic != 0x46546C67:  # 'glTF'
            raise ValueError(f"{path}: not a GLB file")
        json_chunk = None
        bin_chunk = b""
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            clen, ctype = struct.unpack("<II", header)
            data = f.read(clen)
            if ctype == 0x4E4F534A:  # 'JSON'
                json_chunk = json.loads(data)
            elif ctype == 0x004E4942:  # 'BIN'
                bin_chunk = data
        if json_chunk is None:
            raise ValueError(f"{path}: no JSON chunk")
        return json_chunk, bin_chunk


def _read_accessor(gltf: dict, blob: bytes, accessor_idx: int) -> np.ndarray:
    acc = gltf["accessors"][accessor_idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride")
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride and stride != itemsize:
        raw = np.frombuffer(
            blob, np.uint8, count * stride - (stride - itemsize), offset
        )
        rows = np.lib.stride_tricks.as_strided(
            raw, shape=(count, itemsize), strides=(stride, 1)
        ).copy()
        arr = rows.view(dtype).reshape(count, ncomp)
    else:
        arr = np.frombuffer(blob, dtype, count * ncomp, offset).reshape(count, ncomp)
    return arr


def load_glb_triangles(path: str) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Return [(vertices (V,3) f32, faces (F,3) i64), ...] per primitive,
    with node transforms applied when present."""
    gltf, blob = parse_glb(path)
    out = []
    # node world transforms (flat scene graph walk)
    node_tf = {}

    def walk(node_idx, parent):
        node = gltf.get("nodes", [])[node_idx]
        local = np.eye(4)
        if "matrix" in node:
            local = np.array(node["matrix"], dtype=np.float64).reshape(4, 4).T
        else:
            t = node.get("translation", [0, 0, 0])
            r = node.get("rotation", [0, 0, 0, 1])  # xyzw
            s = node.get("scale", [1, 1, 1])
            x, y, z, w = r
            R = np.array(
                [
                    [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                ]
            )
            local[:3, :3] = R * np.asarray(s)[None, :]
            local[:3, 3] = t
        world = parent @ local
        if "mesh" in node:
            node_tf.setdefault(node["mesh"], []).append(world)
        for child in node.get("children", []):
            walk(child, world)

    scenes = gltf.get("scenes", [])
    if scenes:
        for root in scenes[gltf.get("scene", 0)].get("nodes", []):
            walk(root, np.eye(4))

    for mi, mesh in enumerate(gltf.get("meshes", [])):
        transforms = node_tf.get(mi, [np.eye(4)])
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:  # triangles only
                continue
            pos = _read_accessor(gltf, blob, prim["attributes"]["POSITION"]).astype(
                np.float64
            )
            if "indices" in prim:
                idx = _read_accessor(gltf, blob, prim["indices"]).reshape(-1, 3)
            else:
                idx = np.arange(len(pos)).reshape(-1, 3)
            for tf in transforms:
                v = pos @ tf[:3, :3].T + tf[:3, 3]
                out.append((v.astype(np.float32), idx.astype(np.int64)))
    return out


def load_mesh_triangle_centroids(path: str, decimate_factor: float = 1.0) -> np.ndarray:
    if path.endswith(".glb") or path.endswith(".gltf"):
        prims = load_glb_triangles(path)
    else:
        raise NotImplementedError(
            f"{path}: only .glb/.gltf triangle meshes supported; convert with "
            "any mesh tool (the reference's Zero123 pipeline uses .glb too)"
        )
    cents = []
    for verts, faces in prims:
        c = verts[faces].mean(axis=1)
        cents.append(c)
    xyz = np.concatenate(cents, axis=0)
    if decimate_factor != 1.0:
        keep = max(1, int(len(xyz) / decimate_factor))
        idx = np.linspace(0, len(xyz) - 1, keep).astype(np.int64)
        xyz = xyz[idx]
    return xyz.astype(np.float32)
