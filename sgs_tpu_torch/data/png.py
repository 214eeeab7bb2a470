"""PNG reading and writing with the standard library's zlib and numpy.

The card's machine has no PIL, so the port decodes and encodes PNG itself.
Supported: 8-bit, non-interlaced gray (0), RGB (2), gray-alpha (4) and
RGBA (6) images with all five row filters. Anything else raises.

Sub and Up are vectorised over the row; Average and Paeth depend on the
reconstructed byte to their left and run as a per-byte Python loop.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: missing IEND chunk")


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    """In-place Paeth reconstruction of one row (sequential by nature)."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa = abs(p - a)
        pb = abs(p - b)
        pc = abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        line[i] = (line[i] + pred) & 0xFF


def _average_row(line: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prev[i]) >> 1)) & 0xFF


def read_png(path: str) -> np.ndarray:
    """Decode a PNG into a (H, W, C) uint8 array (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        data = f.read()
    header = None
    idat = []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: missing IHDR chunk")
    width, height, depth, color, compression, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or compression or filt or interlace:
        kind = ("palette" if color == 3 else f"{depth}-bit" if depth != 8
                else "interlaced" if interlace else f"color type {color}")
        raise ValueError(
            f"{path}: unsupported PNG: {kind} (bit depth {depth}, color type {color}, "
            f"interlace {interlace}); only 8-bit non-interlaced gray, gray-alpha, "
            "RGB and RGBA are read"
        )
    bpp = _CHANNELS[color]
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: decompressed size {raw.size} does not match the header")
    rows = raw.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:  # Sub: running sum per channel, mod 256
            cur = np.cumsum(line.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out.reshape(height, width, bpp)


def write_png(path: str, image: np.ndarray) -> None:
    """Encode a (H, W, 3) or (H, W, 4) uint8 array (filter 0 on every row)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] not in (3, 4):
        raise ValueError(f"write_png takes (H, W, 3|4) uint8, got {image.dtype} {image.shape}")
    height, width, channels = image.shape
    color = 2 if channels == 3 else 6
    rows = np.concatenate(
        [np.zeros((height, 1), np.uint8), image.reshape(height, width * channels)], axis=1
    )

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))
