"""Animated GIF writing with numpy and the standard library.

The card's machine has no PIL, so the port writes `view`'s `orbit.gif`
itself: GIF89a, one 256-colour palette per frame from a median-cut
quantiser (each frame's colours mapped to the nearest palette entry), LZW
coding with the code width growing from 9 to 12 bits and a clear code
when the table is full, a graphic control extension per frame with its
delay, and the NETSCAPE2.0 loop extension.
"""

from __future__ import annotations

import struct
from typing import List, Sequence, Tuple

import numpy as np


def median_cut(pixels: np.ndarray, colors: int = 256) -> Tuple[np.ndarray, np.ndarray]:
    """(N, 3) uint8 -> (palette (K, 3) uint8 with K <= colors, index (N,) uint8).

    Boxes of distinct colours are split, the box with the widest channel
    range first, at the pixel-weighted median of that channel; the palette
    is each box's pixel-weighted mean, and every colour takes its nearest
    palette entry."""
    key = (pixels[:, 0].astype(np.int32) << 16) | (pixels[:, 1].astype(np.int32) << 8) | pixels[:, 2]
    uniq, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    cols = np.stack([(uniq >> 16) & 255, (uniq >> 8) & 255, uniq & 255], axis=1).astype(np.int64)

    def channel_range(b):
        return np.ptp(cols[b], axis=0) if len(b) > 1 else np.zeros(3, np.int64)

    boxes = [np.arange(len(uniq))]
    ranges = [channel_range(boxes[0])]
    widest = [int(ranges[0].max())]
    while len(boxes) < colors:
        best = int(np.argmax(widest))
        if widest[best] == 0:
            break
        box, rng = boxes.pop(best), ranges.pop(best)
        widest.pop(best)
        axis = int(np.argmax(rng))
        order = box[np.argsort(cols[box, axis], kind="stable")]
        cum = np.cumsum(counts[order])
        cut = int(np.searchsorted(cum, cum[-1] / 2.0))
        cut = min(max(cut, 1), len(order) - 1)
        for half in (order[:cut], order[cut:]):
            boxes.append(half)
            ranges.append(channel_range(half))
            widest.append(int(ranges[-1].max()))
    palette = np.stack([np.round((cols[b] * counts[b, None]).sum(0) / counts[b].sum()) for b in boxes])
    nearest = np.empty(len(uniq), np.int64)
    for s in range(0, len(uniq), 4096):
        d = ((cols[s:s + 4096, None, :] - palette[None, :, :]) ** 2).sum(-1)
        nearest[s:s + 4096] = d.argmin(1)
    return palette.astype(np.uint8), nearest[inverse.reshape(-1)].astype(np.uint8)


def lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a stream of palette indices."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0
    width = min_code_size + 1

    def emit(code: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    table = {}
    next_code = eoi + 1
    emit(clear)
    data = indices.tobytes()
    prefix = data[0] if data else None
    for byte in data[1:]:
        k = (prefix << 8) | byte
        code = table.get(k)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code < 4096:
            table[k] = next_code
            next_code += 1
            if next_code > (1 << width) and width < 12:
                width += 1
        else:
            emit(clear)
            table.clear()
            next_code = eoi + 1
            width = min_code_size + 1
        prefix = byte
    if prefix is not None:
        emit(prefix)
    emit(eoi)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)) + b"\x00"


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: int = 120, loop: int = 0) -> None:
    """Write (H, W, 3) uint8 frames as an animated GIF; `duration_ms` per
    frame (stored in hundredths of a second) and `loop` repeats (0: for ever)."""
    h, w = frames[0].shape[:2]
    parts: List[bytes] = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0)]
    parts.append(b"\x21\xff\x0bNETSCAPE2.0" + struct.pack("<BBHB", 3, 1, loop, 0))
    for frame in frames:
        if frame.shape != (h, w, 3):
            raise ValueError(f"frame of shape {frame.shape}, expected {(h, w, 3)}")
        palette, index = median_cut(frame.reshape(-1, 3))
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette
        parts.append(b"\x21\xf9\x04" + struct.pack("<BHBB", 0x04, duration_ms // 10, 0, 0))
        parts.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87) + table.tobytes())
        parts.append(b"\x08" + _sub_blocks(lzw_encode(index, 8)))
    parts.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(parts))


def read_gif_info(path: str) -> dict:
    """The fields `chip_smoke.py` checks: the header, the screen size, the
    loop count, the frame count and each frame's delay (ms), read by
    walking the blocks (the image data is not decoded)."""
    data = open(path, "rb").read()
    info = {"header": data[:6].decode("ascii", "replace"), "size": struct.unpack("<HH", data[6:10]),
            "loop": None, "delays_ms": [], "frames": 0}
    pos = 13
    if data[10] & 0x80:
        pos += 3 * (2 << (data[10] & 7))
    while pos < len(data):
        kind = data[pos]
        if kind == 0x3B:
            break
        if kind == 0x21:
            label = data[pos + 1]
            body = data[pos + 2:pos + 2 + data[pos + 2] + 1]
            if label == 0xFF and body[1:12] == b"NETSCAPE2.0":
                info["loop"] = struct.unpack("<H", data[pos + 16:pos + 18])[0]
            elif label == 0xF9:
                info["delays_ms"].append(10 * struct.unpack("<H", data[pos + 4:pos + 6])[0])
            pos += 2
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
        elif kind == 0x2C:
            info["frames"] += 1
            packed = data[pos + 9]
            pos += 10
            if packed & 0x80:
                pos += 3 * (2 << (packed & 7))
            pos += 1  # LZW minimum code size
            while data[pos]:
                pos += data[pos] + 1
            pos += 1
        else:
            raise ValueError(f"{path}: unknown GIF block 0x{kind:02X} at byte {pos}")
    return info
