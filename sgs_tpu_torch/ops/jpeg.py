"""Native JPEG decoding: the stages of `data/jpeg.py` in host C++
(`csrc/jpeg.cu`), equal to the plain version and to PIL bit for bit.

The markers are parsed in Python (`data/jpeg.py::parse_jpeg`); each scan's
entropy-coded bytes go to `jpeg_decode_scan` (sequential) or
`jpeg_decode_progressive_scan` with the Huffman lookup tables; a
progressive file whose coefficients are not all known goes through
`jpeg_smooth` (libjpeg's block smoothing, component by component, into a
copy); then `jpeg_reconstruct` dequantises, runs the islow IDCT, upsamples
and converts the colours. The progression's bookkeeping (`coef_bits`,
whether to smooth) is the plain version's, on the parse. Decoding runs on
the host, as libjpeg does for the JAX package: the readers resize and
composite in host numpy. The library is built by `ops/build.py` with
nvcc, as the kernels are; a build that fails raises. `DECODER.launches`
counts the decoded images.
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
        "jpeg_decode_progressive_scan": [PTR, ctypes.c_longlong, INT, PTR, PTR, INT, INT, INT, INT, INT, INT,
                                         INT, INT, PTR, PTR, PTR, PTR],
        "jpeg_smooth": [PTR, PTR, INT, INT, INT, INT, INT, PTR, PTR, PTR, INT],
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


def _luts(tables) -> np.ndarray:
    """The scan's lookup tables, one row each (zeros for a table the scan
    does not read)."""
    return np.ascontiguousarray(np.stack([t.lut() if t is not None else np.zeros(65536, np.int32)
                                          for t in tables]))


def decode_native(data: bytes, name: str = "<bytes>") -> np.ndarray:
    frame = plain.parse_jpeg(data, name)
    lib = DECODER.lib()
    coefs = plain.alloc_coefficients(frame)
    coef_ptrs = (ctypes.c_void_p * len(coefs))(*[_ptr(c) for c in coefs])
    alloc_w = np.array([c.alloc_w for c in frame.components], np.int32)
    last_good = 0  # as data/jpeg.py::decode_plain keeps it
    for scan in frame.scans:
        mcus_w, mcus_h, blocks = plain.scan_layout(frame, scan)
        one = len(blocks) == 1
        plan = np.array([(k, ci, by, bx, 1 if one else frame.components[ci].v,
                          1 if one else frame.components[ci].h) for k, ci, by, bx in blocks], np.int32)
        dc, ac = _luts(scan.dc), _luts(scan.ac)
        buf = np.frombuffer(scan.data, np.uint8) if scan.data else np.zeros(1, np.uint8)
        if not frame.progressive:
            _check(lib.jpeg_decode_scan(_ptr(buf), len(scan.data), len(blocks), _ptr(plan), _ptr(alloc_w),
                                        mcus_w, mcus_h, scan.restart_interval, _ptr(dc), _ptr(ac),
                                        ctypes.cast(coef_ptrs, ctypes.c_void_p)), name)
            continue
        good = ctypes.c_int(-1)
        rows_per_imcu = frame.components[scan.comps[0]].v if one else 1
        _check(lib.jpeg_decode_progressive_scan(
            _ptr(buf), len(scan.data), len(blocks), _ptr(plan), _ptr(alloc_w), mcus_w, mcus_h,
            scan.restart_interval, scan.ss, scan.se, scan.ah, scan.al, rows_per_imcu, _ptr(dc), _ptr(ac),
            ctypes.cast(coef_ptrs, ctypes.c_void_p), ctypes.addressof(good)), name)
        if good.value >= 0:
            last_good = good.value
    if frame.progressive:
        bits = plain.coefficient_bits(frame)
        if plain.smoothing_wanted(frame, bits):
            smoothed = [c.copy() for c in coefs]
            for ci, c in enumerate(frame.components):
                q = np.ascontiguousarray(c.qtable, np.int32)
                cur = np.ascontiguousarray(bits[0, ci, :10], np.int32)
                prev = np.ascontiguousarray(bits[1, ci, :10], np.int32)
                _check(lib.jpeg_smooth(_ptr(coefs[ci]), _ptr(smoothed[ci]), c.alloc_w, c.blocks_w, c.blocks_h,
                                       c.v, frame.mcuy, _ptr(q), _ptr(cur), _ptr(prev), last_good), name)
            coefs = smoothed
            coef_ptrs = (ctypes.c_void_p * len(coefs))(*[_ptr(c) for c in coefs])
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
