"""Native JPEG decoding: the stages of `data/jpeg.py` in host C++
(`csrc/jpeg.cu`), equal to the plain version and to PIL bit for bit.

The markers are parsed in Python (`data/jpeg.py::parse_jpeg`); each scan's
entropy-coded bytes go to `jpeg_decode_scan` with the Huffman lookup
tables, then `jpeg_reconstruct` dequantises, runs the islow IDCT, upsamples
and converts the colours. Decoding runs on the host, as libjpeg does for
the JAX package: the readers resize and composite in host numpy. The
library is built by `ops/build.py` with nvcc, as the kernels are; a build
that fails raises. `DECODER.launches` counts the decoded images.
"""

from __future__ import annotations

import ctypes

import numpy as np

from sgs_tpu_torch.data import jpeg as plain
from sgs_tpu_torch.ops.build import INT, PTR, CudaKernel

DECODER = CudaKernel(
    "jpeg.cu",
    {
        "jpeg_decode_scan": [PTR, ctypes.c_longlong, INT, PTR, PTR, INT, INT, INT, PTR, PTR, PTR],
        "jpeg_reconstruct": [INT, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR],
    },
)
_ERRORS = {1: "a bad Huffman code", 2: "premature end of the scan data", 3: "a missing restart marker",
           4: "a fractional sampling ratio"}
_COLOR = {"gray": 0, "ycc": 1, "rgb": 2}


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _check(rc: int, name: str) -> None:
    if rc:
        raise ValueError(f"{name}: corrupt JPEG: {_ERRORS.get(rc, f'error {rc}')}")


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    frame = plain.parse_jpeg(data, name)
    lib = DECODER.lib()
    coefs = plain.alloc_coefficients(frame)
    coef_ptrs = (ctypes.c_void_p * len(coefs))(*[_ptr(c) for c in coefs])
    alloc_w = np.array([c.alloc_w for c in frame.components], np.int32)
    for scan in frame.scans:
        mcus_w, mcus_h, blocks = plain.scan_layout(frame, scan)
        one = len(blocks) == 1
        plan = np.array([(k, ci, by, bx, 1 if one else frame.components[ci].v,
                          1 if one else frame.components[ci].h) for k, ci, by, bx in blocks], np.int32)
        dc = np.ascontiguousarray(np.stack([t.lut() for t in scan.dc]))
        ac = np.ascontiguousarray(np.stack([t.lut() for t in scan.ac]))
        buf = np.frombuffer(scan.data, np.uint8) if scan.data else np.zeros(1, np.uint8)
        _check(lib.jpeg_decode_scan(_ptr(buf), len(scan.data), len(blocks), _ptr(plan), _ptr(alloc_w),
                                    mcus_w, mcus_h, scan.restart_interval, _ptr(dc), _ptr(ac),
                                    ctypes.cast(coef_ptrs, ctypes.c_void_p)), name)
    comp = np.array([(c.h, c.v, c.alloc_w, c.alloc_h, c.width, c.height) for c in frame.components], np.int32)
    qt = np.ascontiguousarray(np.stack([c.qtable for c in frame.components]).astype(np.int32))
    nc = len(frame.components)
    out = np.empty((frame.height, frame.width, nc), np.uint8)
    _check(lib.jpeg_reconstruct(nc, _ptr(comp), ctypes.cast(coef_ptrs, ctypes.c_void_p), _ptr(qt), frame.hmax,
                                frame.vmax, frame.width, frame.height, _COLOR[frame.color], _ptr(out)), name)
    DECODER.launches += 1
    return out[..., 0] if frame.color == "gray" else out


def read_jpeg_native(path: str) -> np.ndarray:
    """(H, W, 3) or (H, W) uint8 of a JPEG file, as np.asarray(PIL.Image.open(path))."""
    with open(path, "rb") as f:
        return decode_native(f.read(), path)
