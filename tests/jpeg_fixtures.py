"""Writes the committed JPEG fixtures (imports PIL; not collected as a test).

    PYTHONPATH=. python tests/jpeg_fixtures.py

- `data/jpeg_cases/`: small and odd sizes in every sampling the port
  decodes. PIL writes 4:4:4, 4:2:2, 4:2:0 and grayscale, with restart
  intervals, optimised Huffman tables and a 16-bit quantisation table
  (SOF1); `encode_baseline` below writes what PIL cannot (true 4:1:1,
  4:4:0, 4x2 luma, chroma sampled finer than luma, one scan per
  component, a 2x2 grayscale, an Adobe RGB file). Progressive cases: PIL's
  own (`progressive=True`) at 4:4:4, 4:2:2, 4:2:0 and gray with restart
  intervals, and `encode_progressive`'s for what PIL cannot write (a DC
  scan per component, uneven AC bands, point transforms up to 3, one
  end-of-band run over most blocks, refinements in another order, and
  incomplete scripts that libjpeg smooths), and two files whose scan data
  ends early (`cut_scan`). The 4946x3286 frame (a MipNeRF360
  full-resolution size) is a flagship view enlarged by PIL and saved at
  quality 95, 4:2:0, baseline and progressive. `digests.json` holds, for
  every case, the sha256 and shape of `np.asarray(PIL.Image.open(case))`.
- `data/colmap_flagship800_jpg/`: the 56 views of data/flagship800,
  composited on black as the Blender reader composites them, saved by PIL
  at quality 95, 4:2:0, with the COLMAP copy's `sparse/0`
  (`sgs_tpu_torch.tools.colmap_scene`).

Rerunning it writes the same bytes (the images are seeded).
"""

from __future__ import annotations

import hashlib
import io
import json
import re
import os
import shutil
import sys

import numpy as np
from PIL import Image

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = os.path.join(ROOT, "data", "jpeg_cases")
FLAGSHIP_JPG = os.path.join(ROOT, "data", "colmap_flagship800_jpg")
BIG_SIZE = (4946, 3286)

# Annex K's example tables
_LUM_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
          14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
          49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
_CHR_Q = [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99,
          47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32
_DC_BITS = [[0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]]
_DC_VALS = [list(range(12)), list(range(12))]
_AC_BITS = [[0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D],
            [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]]


def _runs(*spans):
    return [b for lo, hi in spans for b in range(lo, hi + 1)]


_AC_VALS = [
    bytes([0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
           0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
           0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
           0x29, 0x2A] + _runs((0x34, 0x3A), (0x43, 0x4A), (0x53, 0x5A), (0x63, 0x6A), (0x73, 0x7A),
                               (0x83, 0x8A), (0x92, 0x9A), (0xA2, 0xAA), (0xB2, 0xBA), (0xC2, 0xCA),
                               (0xD2, 0xDA), (0xE1, 0xEA), (0xF1, 0xFA))),
    bytes([0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
           0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
           0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
           0x27, 0x28, 0x29, 0x2A] + _runs((0x35, 0x3A), (0x43, 0x4A), (0x53, 0x5A), (0x63, 0x6A),
                                           (0x73, 0x7A), (0x82, 0x8A), (0x92, 0x9A), (0xA2, 0xAA),
                                           (0xB2, 0xBA), (0xC2, 0xCA), (0xD2, 0xDA), (0xE2, 0xEA),
                                           (0xF2, 0xFA))),
]
assert [len(v) for v in _AC_VALS] == [sum(b) for b in _AC_BITS] == [162, 162]
_ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,
           6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45,
           38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _codes(bits, vals):
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _category(v):
    a = abs(v)
    s = a.bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def _segment(marker, body):
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _quantised(image, sampling, quality_scale, adobe_rgb, qt16):
    """The components' quantised DCT blocks, (alloc_h, alloc_w, 64) ints in
    natural order (whole MCUs, edges replicated), the two quantisation
    tables and the image size."""
    img = np.asarray(image, np.float64)
    if img.ndim == 2:
        planes = [img]
    elif adobe_rgb:
        planes = [img[..., c] for c in range(3)]
    else:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        planes = [0.299 * r + 0.587 * g + 0.114 * b,
                  -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    H, W = img.shape[:2]
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    qts = [np.clip(np.round(np.array(q) * quality_scale), 1, 255).astype(int) for q in (_LUM_Q, _CHR_Q)]
    if qt16:
        qts[1] = qts[1] * 4 + 200  # over 255: a 16-bit table, so SOF1
    n = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)
    blocks = []
    for ci, (plane, (h, v)) in enumerate(zip(planes, sampling)):
        fx, fy = hmax // h, vmax // v
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        pad = np.pad(plane, ((0, ch * fy - H if ch * fy > H else 0), (0, cw * fx - W if cw * fx > W else 0)),
                     mode="edge")[:ch * fy, :cw * fx]
        small = pad.reshape(ch, fy, cw, fx).mean(axis=(1, 3))
        aw, ah = mcux * h, mcuy * v
        full = np.pad(small, ((0, ah * 8 - ch), (0, aw * 8 - cw)), mode="edge") - 128
        b = full.reshape(ah, 8, aw, 8).transpose(0, 2, 1, 3)
        coef = dct @ b @ dct.T
        q = qts[0 if ci == 0 else 1].reshape(8, 8)
        blocks.append(np.round(coef / q).astype(int).reshape(ah, aw, 64))
    return blocks, qts, H, W


def _frame_header(qts, tabs, H, W, sampling, ids, sof, adobe_rgb=False, qt16=False):
    """SOI, JFIF or Adobe, DQT and the SOF segment."""
    out = bytearray(b"\xff\xd8")
    if adobe_rgb:
        out += _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
    else:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in sorted(set(tabs)):
        zz = qts[t][_ZIGZAG]
        if qt16 and t == 1:
            out += _segment(0xDB, bytes([0x10 | t]) + b"".join(int(x).to_bytes(2, "big") for x in zz))
        else:
            out += _segment(0xDB, bytes([t]) + bytes(int(x) for x in zz))
    body = bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + bytes([len(tabs)])
    for ci in range(len(tabs)):
        body += bytes([ids[ci], (sampling[ci][0] << 4) | sampling[ci][1], tabs[ci]])
    out += _segment(sof, body)
    return out


def encode_baseline(image, sampling, quality_scale=1.0, restart=0, interleaved=True, adobe_rgb=False,
                    qt16=False, ids=(1, 2, 3)):
    """A baseline JPEG (SOF0, or SOF1 with a 16-bit table) with the given
    sampling factors [(h, v), ...]: 1 or 3 components, Annex K Huffman
    tables, a float DCT. The decoder under test is held to PIL's decode of
    it, so the encoder needs no accuracy of its own."""
    blocks, qts, H, W = _quantised(image, sampling, quality_scale, adobe_rgb, qt16)
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    nc = len(blocks)
    tabs = [0 if ci == 0 else 1 for ci in range(nc)]
    out = _frame_header(qts, tabs, H, W, sampling, ids, 0xC1 if qt16 else 0xC0, adobe_rgb, qt16)
    for t in sorted(set(tabs)):
        out += _segment(0xC4, bytes([t]) + bytes(_DC_BITS[t]) + bytes(_DC_VALS[t]))
        out += _segment(0xC4, bytes([0x10 | t]) + bytes(_AC_BITS[t]) + _AC_VALS[t])
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    dc_codes = [_codes(_DC_BITS[t], _DC_VALS[t]) for t in (0, 1)]
    ac_codes = [_codes(_AC_BITS[t], list(_AC_VALS[t])) for t in (0, 1)]
    scans = [list(range(nc))] if interleaved and nc > 1 else [[ci] for ci in range(nc)]
    for comps in scans:
        hdr = bytes([len(comps)])
        for ci in comps:
            hdr += bytes([ids[ci], (tabs[ci] << 4) | tabs[ci]])
        out += _segment(0xDA, hdr + bytes([0, 63, 0]))
        if len(comps) == 1:
            c = comps[0]
            h, v = sampling[c]
            cw, ch = -(-W * h // hmax), -(-H * v // vmax)
            units = [[(c, by, bx)] for by in range(-(-ch // 8)) for bx in range(-(-cw // 8))]
        else:
            units = [[(c, my * sampling[c][1] + by, mx * sampling[c][0] + bx)
                      for c in comps for by in range(sampling[c][1]) for bx in range(sampling[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        bits, pred, rst = _Bits(), [0] * nc, 0
        for u, unit in enumerate(units):
            if restart and u and u % restart == 0:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
                bits, pred = _Bits(), [0] * nc
            for c, by, bx in unit:
                zz = blocks[c][by, bx][_ZIGZAG]
                d = int(zz[0]) - pred[c]
                pred[c] = int(zz[0])
                s, val = _category(d)
                bits.put(*dc_codes[tabs[c]][s])
                if s:
                    bits.put(val, s)
                run = 0
                last = max([k for k in range(1, 64) if zz[k] != 0], default=0)
                for k in range(1, last + 1):
                    if zz[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits.put(*ac_codes[tabs[c]][0xF0])
                        run -= 16
                    s, val = _category(int(zz[k]))
                    bits.put(*ac_codes[tabs[c]][(run << 4) | s])
                    bits.put(val, s)
                    run = 0
                if last < 63:
                    bits.put(*ac_codes[tabs[c]][0])
        bits.flush()
        out += bits.out
    out += b"\xff\xd9"
    return bytes(out)


def optimal_table(freq):
    """(bits, values) of libjpeg's jpeg_gen_optimal_table for symbol counts
    {symbol: count}: Huffman code lengths with a reserved all-ones code,
    limited to 16 bits."""
    f = [0] * 257
    for sym, n in freq.items():
        f[sym] = n
    f[256] = 1
    size, others = [0] * 257, [-1] * 257
    while True:
        live = [i for i in range(257) if f[i]]
        if len(live) < 2:
            break
        c1 = min(live, key=lambda i: (f[i], -i))
        c2 = min((i for i in live if i != c1), key=lambda i: (f[i], -i))
        f[c1] += f[c2]
        f[c2] = 0
        for c in (c1, c2):
            size[c] += 1
            while others[c] >= 0:
                c = others[c]
                size[c] += 1
        c = c1
        while others[c] >= 0:
            c = others[c]
        others[c] = c2
    bits = [0] * 33
    for i in range(257):
        if size[i]:
            bits[size[i]] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the pseudo-symbol 256
    values = [sym for n in range(1, 33) for sym in range(256) if size[sym] == n]
    return bits[1:17], values


def _scan_tokens(blocks, sampling, comps, ss, se, ah, al, H, W, restart):
    """One progressive scan as jcphuff.c codes it: a list of ("sym", table
    class, component, symbol), ("bits", value, n) and ("rst",) tokens."""
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    if len(comps) == 1:
        c = comps[0]
        h, v = sampling[c]
        cw, ch = -(-W * h // hmax), -(-H * v // vmax)
        units = [[(c, by, bx)] for by in range(-(-ch // 8)) for bx in range(-(-cw // 8))]
    else:
        units = [[(c, my * sampling[c][1] + by, mx * sampling[c][0] + bx)
                  for c in comps for by in range(sampling[c][1]) for bx in range(sampling[c][0])]
                 for my in range(mcuy) for mx in range(mcux)]
    out = []
    state = {"eobrun": 0, "be": [], "comp": comps[0]}

    def emit_eobrun():
        if state["eobrun"]:
            n = state["eobrun"].bit_length() - 1
            out.append(("sym", 1, state["comp"], n << 4))
            if n:
                out.append(("bits", state["eobrun"], n))
            state["eobrun"] = 0
            out.extend(("bits", b, 1) for b in state["be"])
            state["be"] = []

    pred = {c: 0 for c in comps}
    for u, unit in enumerate(units):
        if restart and u and u % restart == 0:
            emit_eobrun()
            out.append(("rst",))
            pred = {c: 0 for c in comps}
        for c, by, bx in unit:
            zz = [int(x) for x in blocks[c][by, bx][_ZIGZAG]]
            if ss == 0 and ah == 0:  # DC first: the point-transformed difference
                t = zz[0] >> al
                d, pred[c] = t - pred[c], t
                n, val = _category(d)
                out.append(("sym", 0, c, n))
                if n:
                    out.append(("bits", val, n))
            elif ss == 0:  # DC refine: the next bit
                out.append(("bits", (zz[0] >> al) & 1, 1))
            elif ah == 0:  # AC first
                r = 0
                for k in range(ss, se + 1):
                    t = abs(zz[k]) >> al
                    if t == 0:
                        r += 1
                        continue
                    emit_eobrun()
                    while r > 15:
                        out.append(("sym", 1, c, 0xF0))
                        r -= 16
                    n = t.bit_length()
                    out.append(("sym", 1, c, (r << 4) | n))
                    out.append(("bits", t if zz[k] > 0 else ~t & ((1 << n) - 1), n))
                    r = 0
                if r:
                    state["eobrun"] += 1
                    if state["eobrun"] == 0x7FFF:
                        emit_eobrun()
            else:  # AC refine: newly nonzero coefficients, correction bits
                absv = {k: abs(zz[k]) >> al for k in range(ss, se + 1)}
                eob = max([k for k in absv if absv[k] == 1], default=0)
                r, br = 0, []
                for k in range(ss, se + 1):
                    t = absv[k]
                    if t == 0:
                        r += 1
                        continue
                    while r > 15 and k <= eob:
                        emit_eobrun()
                        out.append(("sym", 1, c, 0xF0))
                        r -= 16
                        out.extend(("bits", b, 1) for b in br)
                        br = []
                    if t > 1:
                        br.append(t & 1)
                        continue
                    emit_eobrun()
                    out.append(("sym", 1, c, (r << 4) | 1))
                    out.append(("bits", 0 if zz[k] < 0 else 1, 1))
                    out.extend(("bits", b, 1) for b in br)
                    br = []
                    r = 0
                if r > 0 or br:
                    state["eobrun"] += 1
                    state["be"] += br
                    if state["eobrun"] == 0x7FFF or len(state["be"]) > 1000 - 64 + 1:
                        emit_eobrun()
    emit_eobrun()
    return out


def encode_progressive(image, sampling, script, quality_scale=1.0, restart=0, blocks=None):
    """A progressive JPEG (SOF2) of the image, or of given quantised
    `blocks` (with `image` then giving only the size), with the scan
    script [(components, Ss, Se, Ah, Al), ...] and, before each scan, the
    optimal Huffman tables of that scan (DC table 0, AC table 0 for the
    first component and 1 for the others). The script may be any PIL
    cannot write: a DC scan per component, uneven bands, Al up to 13,
    refinements in any order, scans left out."""
    if blocks is None:
        blocks, qts, H, W = _quantised(image, sampling, quality_scale, False, False)
    else:
        qts = [np.ones(64, int), np.ones(64, int)]
        H, W = np.asarray(image).shape[:2]
    nc = len(blocks)
    tabs = [0 if ci == 0 else 1 for ci in range(nc)]
    ids = (1, 2, 3)
    out = _frame_header(qts, tabs, H, W, sampling, ids, 0xC2)
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    for comps, ss, se, ah, al in script:
        tokens = _scan_tokens(blocks, sampling, comps, ss, se, ah, al, H, W, restart)
        freq = {}
        for t in tokens:
            if t[0] == "sym":
                key = (t[1], tabs[t[2]] if t[1] else 0)
                freq.setdefault(key, {}).setdefault(t[3], 0)
                freq[key][t[3]] += 1
        codes = {}
        for (cls, tid), f in sorted(freq.items()):
            bits, values = optimal_table(f)
            out += _segment(0xC4, bytes([(cls << 4) | tid]) + bytes(bits) + bytes(values))
            codes[(cls, tid)] = _codes(bits, values)
        hdr = bytes([len(comps)])
        for ci in comps:
            hdr += bytes([ids[ci], tabs[ci] if ss else 0])
        out += _segment(0xDA, hdr + bytes([ss, se, (ah << 4) | al]))
        bits, rst = _Bits(), 0
        for t in tokens:
            if t[0] == "sym":
                bits.put(*codes[(t[1], tabs[t[2]] if t[1] else 0)][t[3]])
            elif t[0] == "bits":
                bits.put(t[1] & ((1 << t[2]) - 1), t[2])
            else:
                bits.flush()
                out += bits.out + bytes([0xFF, 0xD0 + rst])
                rst = (rst + 1) % 8
                bits = _Bits()
        bits.flush()
        out += bits.out
    out += b"\xff\xd9"
    return bytes(out)


def simple_script(nc, al=1):
    """libjpeg's jpeg_simple_progression (what PIL writes with
    progressive=True), its first point transforms raised by al - 1 and one
    more refinement scan of each kind per step."""
    if nc == 1:
        script = [([0], 0, 0, 0, al), ([0], 1, 5, 0, al + 1), ([0], 6, 63, 0, al + 1), ([0], 1, 63, al + 1, al)]
        for a in range(al, 0, -1):
            script += [([0], 0, 0, a, a - 1), ([0], 1, 63, a, a - 1)]
        return script
    script = [([0, 1, 2], 0, 0, 0, al), ([0], 1, 5, 0, al + 1), ([2], 1, 63, 0, al), ([1], 1, 63, 0, al),
              ([0], 6, 63, 0, al + 1), ([0], 1, 63, al + 1, al)]
    for a in range(al, 0, -1):
        script += [([0, 1, 2], 0, 0, a, a - 1), ([2], 1, 63, a, a - 1), ([1], 1, 63, a, a - 1),
                   ([0], 1, 63, a, a - 1)]
    return script


def random_script(rng, nc, max_al=3, complete=True):
    """A seeded legal progression: per component a DC first scan (the
    components together or one scan each) and its refinements, the AC
    coefficients in 1-4 bands of uneven width, each band's first scan at
    a point transform up to max_al and its refinements; scans in a random
    order that keeps each coefficient's scans in sequence and every AC
    scan after its component's first DC scan. With complete=False each
    chain may stop before its last refinement (a file to smooth)."""
    chains = []  # lists of scans that must stay in order
    dc_al = int(rng.integers(0, max_al + 1))
    dc_stop = 0 if complete else int(rng.integers(0, dc_al + 1))
    groups = [list(range(nc))] if nc > 1 and rng.random() < 0.7 else [[c] for c in range(nc)]
    dc_first = []
    for g in groups:
        chain = [(g, 0, 0, 0, dc_al)] + [(g, 0, 0, a, a - 1) for a in range(dc_al, dc_stop, -1)]
        dc_first.append(chain[0])
        chains.append(chain)
    for c in range(nc):
        cuts = sorted(rng.choice(np.arange(2, 64), int(rng.integers(0, 4)), replace=False).tolist())
        edges = [1] + cuts + [64]
        for lo, hi in zip(edges[:-1], edges[1:]):
            al = int(rng.integers(0, max_al + 1))
            stop = 0 if complete else int(rng.integers(0, al + 1))
            chains.append([([c], lo, hi - 1, 0, al)] + [([c], lo, hi - 1, a, a - 1) for a in range(al, stop, -1)])
    script, heads = [], [0] * len(chains)
    done_dc = set()
    while any(h < len(ch) for h, ch in zip(heads, chains)):
        ready = [i for i, ch in enumerate(chains) if heads[i] < len(ch)
                 and (ch[heads[i]][1] == 0 or ch[heads[i]][0][0] in done_dc)]
        i = ready[int(rng.integers(0, len(ready)))]
        scan = chains[i][heads[i]]
        heads[i] += 1
        script.append(scan)
        if scan[1] == 0:
            done_dc.update(scan[0])
    if not complete and all(h == len(ch) for h, ch in zip(heads, chains)) and rng.random() < 0.5:
        # also leave out whole scans at the end, keeping every component's DC
        keep = len(script) - int(rng.integers(0, max(1, len(script) - len(dc_first))))
        script = script[:max(keep, len(dc_first))]
        for first in dc_first:
            if first not in script:
                script.insert(0, first)
    return script


def sample_image(h, w, seed, gray=False):
    """A seeded image with smooth gradients, edges and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 128 + 100 * np.sin(np.stack([xx * 0.21, yy * 0.13, (xx + yy) * 0.07], -1) + rng.uniform(0, 6, 3))
    base[(xx // 7 + yy // 5) % 3 == 0] *= 0.4
    img = np.clip(base + rng.normal(size=base.shape) * 12, 0, 255).astype(np.uint8)
    return img[..., 0] if gray else img


def pil_bytes(image, **kw):
    b = io.BytesIO()
    Image.fromarray(image).save(b, "JPEG", **kw)
    return b.getvalue()


def pil_digest(path):
    a = np.asarray(Image.open(path))
    return {"sha256": hashlib.sha256(a.tobytes()).hexdigest(), "shape": list(a.shape)}


def small_cases():
    """{file name: JPEG bytes} of the small committed cases."""
    q16 = [list(range(1, 65)), [300 + i for i in range(64)]]
    cases = {
        "pil_444_q75_37x23.jpg": pil_bytes(sample_image(23, 37, 1), quality=75, subsampling=0),
        "pil_422_q90_rstblocks3_61x45.jpg": pil_bytes(sample_image(45, 61, 2), quality=90, subsampling=1,
                                                      restart_marker_blocks=3),
        "pil_420_q95_opt_101x77.jpg": pil_bytes(sample_image(77, 101, 3), quality=95, subsampling=2,
                                                optimize=True),
        "pil_420_q50_rstrows1_250x131.jpg": pil_bytes(sample_image(131, 250, 4), quality=50, subsampling=2,
                                                      restart_marker_rows=1),
        "pil_420_q1_17x9.jpg": pil_bytes(sample_image(9, 17, 5), quality=1, subsampling=2),
        "pil_420_q80_3x5.jpg": pil_bytes(sample_image(5, 3, 6), quality=80, subsampling=2),
        "pil_gray_q85_opt_33x17.jpg": pil_bytes(sample_image(17, 33, 7, gray=True), quality=85, optimize=True),
        "pil_sof1_qt16_29x31.jpg": pil_bytes(sample_image(31, 29, 8), qtables=q16, subsampling=2),
        "pil_420_q92_rstblocks1_opt_200x160.jpg": pil_bytes(sample_image(160, 200, 9), quality=92,
                                                            subsampling=2, restart_marker_blocks=1,
                                                            optimize=True),
        "enc_411_45x19.jpg": encode_baseline(sample_image(19, 45, 10), [(4, 1), (1, 1), (1, 1)]),
        "enc_440_33x27.jpg": encode_baseline(sample_image(27, 33, 11), [(1, 2), (1, 1), (1, 1)]),
        "enc_h4v2_70x37.jpg": encode_baseline(sample_image(37, 70, 12), [(4, 2), (1, 1), (1, 1)], restart=2),
        "enc_y22_c12_41x43.jpg": encode_baseline(sample_image(43, 41, 13), [(2, 2), (1, 2), (1, 2)]),
        "enc_y11_c22_26x22.jpg": encode_baseline(sample_image(22, 26, 14), [(1, 1), (2, 2), (2, 2)]),
        "enc_420_separate_scans_53x29.jpg": encode_baseline(sample_image(29, 53, 15), [(2, 2), (1, 1), (1, 1)],
                                                            interleaved=False, restart=5),
        "enc_gray_22_19x21.jpg": encode_baseline(sample_image(21, 19, 16, gray=True), [(2, 2)]),
        "enc_adobe_rgb_24x18.jpg": encode_baseline(sample_image(18, 24, 17), [(1, 1), (1, 1), (1, 1)],
                                                   adobe_rgb=True),
        "enc_h3v1_40x16.jpg": encode_baseline(sample_image(16, 40, 18), [(3, 1), (1, 1), (1, 1)],
                                              quality_scale=0.5),
        "enc_sof1_qt16_h2v4_30x50.jpg": encode_baseline(sample_image(50, 30, 19), [(2, 4), (1, 1), (1, 1)],
                                                        qt16=True),
    }
    return cases


def big_image():
    """A flagship view enlarged to 4946x3286 by PIL."""
    src = Image.open(os.path.join(ROOT, "data", "flagship800", "train", "r_3.png")).convert("RGB")
    w, h = BIG_SIZE
    crop = src.crop((0, (800 - 800 * h // w) // 2, 800, (800 - 800 * h // w) // 2 + 800 * h // w))
    return np.asarray(crop.resize((w, h), Image.BICUBIC))


def big_frame(progressive=False):
    """The enlarged view saved by PIL at quality 95, 4:2:0."""
    return pil_bytes(big_image(), quality=95, subsampling=2, progressive=progressive)


def keep_scans(data, n):
    """The file with only its first n scans (EOI after the n-th scan's data)."""
    i = [m.start() for m in re.finditer(b"\xff\xda", data)][n - 1]
    begin = i + 2 + ((data[i + 2] << 8) | data[i + 3])
    end = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]").search(data, begin).start()
    return data[:end] + b"\xff\xd9"


def cut_scan(data, scan, keep):
    """The file with scan `scan`'s entropy-coded data cut to its first
    `keep` bytes (the markers after it kept): a scan whose data ends early."""
    starts = [m.start() for m in re.finditer(b"\xff\xda", data)]
    i = starts[scan]
    begin = i + 2 + ((data[i + 2] << 8) | data[i + 3])
    end = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]").search(data, begin).start()
    cut = begin + keep
    while data[cut - 1] == 0xFF:
        cut -= 1
    assert cut < end
    return data[:cut] + data[end:]


def progressive_cases():
    """{file name: JPEG bytes} of the small progressive cases."""
    rgb3 = [(1, 1)] * 3
    s420 = [(2, 2), (1, 1), (1, 1)]
    uneven = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 2, 0, 2), ([0], 3, 20, 0, 3), ([0], 21, 63, 0, 1),
              ([1], 1, 9, 0, 0), ([1], 10, 63, 0, 2), ([2], 1, 63, 0, 1), ([0], 3, 20, 3, 2), ([0], 1, 2, 2, 1),
              ([0], 3, 20, 2, 1), ([0, 1, 2], 0, 0, 1, 0), ([1], 10, 63, 2, 1), ([0], 21, 63, 1, 0),
              ([2], 1, 63, 1, 0), ([0], 1, 2, 1, 0), ([1], 10, 63, 1, 0), ([0], 3, 20, 1, 0)]
    separate_dc = [([0], 0, 0, 0, 2), ([2], 0, 0, 0, 0), ([1], 0, 0, 0, 1), ([0], 1, 63, 0, 0), ([1], 1, 63, 0, 0),
                   ([2], 1, 63, 0, 0), ([0], 0, 0, 2, 1), ([1], 0, 0, 1, 0), ([0], 0, 0, 1, 0)]
    # refinements before the chroma's first AC scans, chroma refined before luma
    reordered = [([0, 1, 2], 0, 0, 0, 3), ([0], 1, 63, 0, 3), ([0, 1, 2], 0, 0, 3, 2), ([0], 1, 63, 3, 2),
                 ([2], 1, 63, 0, 2), ([0, 1, 2], 0, 0, 2, 1), ([2], 1, 63, 2, 1), ([1], 1, 63, 0, 1),
                 ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0), ([0], 1, 63, 2, 1), ([0, 1, 2], 0, 0, 1, 0),
                 ([0], 1, 63, 1, 0)]
    # one end-of-band run over most of a flat image's blocks
    flat = np.full((120, 200, 3), 90, np.uint8)
    flat[40:60, 70:90] = (200, 30, 60)
    # incomplete scripts: smoothing estimates the low AC coefficients
    dc_only = [([0, 1, 2], 0, 0, 0, 1)]
    partial = [([0, 1, 2], 0, 0, 0, 2), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1), ([1], 1, 63, 0, 1),
               ([0, 1, 2], 0, 0, 2, 1), ([0], 6, 63, 0, 2), ([0], 1, 5, 2, 1)]
    pil_prog = simple_script(3)
    cases = {
        "pil_prog_444_q75_rstblocks2_37x23.jpg": pil_bytes(sample_image(23, 37, 21), quality=75, subsampling=0,
                                                           progressive=True, restart_marker_blocks=2),
        "pil_prog_422_q90_rstrows1_61x45.jpg": pil_bytes(sample_image(45, 61, 22), quality=90, subsampling=1,
                                                         progressive=True, restart_marker_rows=1),
        "pil_prog_420_q95_101x77.jpg": pil_bytes(sample_image(77, 101, 23), quality=95, subsampling=2,
                                                 progressive=True),
        "pil_prog_420_q60_rstblocks5_250x131.jpg": pil_bytes(sample_image(131, 250, 24), quality=60, subsampling=2,
                                                             progressive=True, restart_marker_blocks=5),
        "pil_prog_gray_q85_rstrows2_33x17.jpg": pil_bytes(sample_image(17, 33, 25, gray=True), quality=85,
                                                          progressive=True, restart_marker_rows=2),
        "enc_prog_separate_dc_420_45x38.jpg": encode_progressive(sample_image(38, 45, 26), s420, separate_dc,
                                                                 restart=3),
        "enc_prog_uneven_bands_444_40x29.jpg": encode_progressive(sample_image(29, 40, 27), rgb3, uneven),
        "enc_prog_al3_reordered_422_53x35.jpg": encode_progressive(sample_image(35, 53, 28),
                                                                   [(2, 1), (1, 1), (1, 1)], reordered),
        "enc_prog_eobrun_420_200x120.jpg": encode_progressive(flat, s420, pil_prog),
        "enc_prog_dc_only_smooth_420_43x40.jpg": encode_progressive(sample_image(40, 43, 29), s420, dc_only),
        "enc_prog_partial_smooth_420_rst4_70x55.jpg": encode_progressive(sample_image(55, 70, 30), s420, partial,
                                                                         restart=4),
        "enc_prog_partial_smooth_y11_c22_26x22.jpg": encode_progressive(
            sample_image(22, 26, 31), [(1, 1), (2, 2), (2, 2)], partial),
        "enc_prog_partial_smooth_gray_16x50.jpg": encode_progressive(
            sample_image(50, 16, 32, gray=True), [(2, 2)],
            [([0], 0, 0, 0, 1), ([0], 1, 2, 0, 1), ([0], 3, 63, 0, 2), ([0], 1, 2, 1, 0)]),
    }
    # a scan whose data ends early: the last of an incomplete file (rows
    # past the one where it ran out smoothed by the earlier coef_bits), and
    # a middle scan with refinements after it (zero-filled coefficients far
    # out of range: the IDCT saturates)
    full = pil_bytes(sample_image(48, 64, 33), quality=80, subsampling=2, progressive=True)
    two_scans = full[:[m.start() for m in re.finditer(b"\xff\xc4|\xff\xda", full)][5]] + b"\xff\xd9"
    cases["pil_prog_420_cut_last_scan_64x48.jpg"] = cut_scan(two_scans, 1, 60)
    cases["pil_prog_gray_cut_mid_scan_64x48.jpg"] = cut_scan(
        pil_bytes(sample_image(48, 64, 34, gray=True), quality=80, progressive=True), 2, 66)
    return cases


def write_cases():
    os.makedirs(CASES, exist_ok=True)
    files = dict(small_cases())
    files.update(progressive_cases())
    files[f"flagship_{BIG_SIZE[0]}x{BIG_SIZE[1]}_q95_420.jpg"] = big_frame()
    files[f"flagship_{BIG_SIZE[0]}x{BIG_SIZE[1]}_q95_420_progressive.jpg"] = big_frame(progressive=True)
    digests = {}
    for name, data in sorted(files.items()):
        path = os.path.join(CASES, name)
        with open(path, "wb") as f:
            f.write(data)
        digests[name] = pil_digest(path)
    with open(os.path.join(CASES, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    return digests


def write_flagship_jpg():
    """data/flagship800 as a COLMAP scene of quality-95 4:2:0 JPEGs."""
    sys.path.insert(0, ROOT)
    from sgs_tpu_torch.data.png import read_png
    from sgs_tpu_torch.data.readers import composite_background
    from sgs_tpu_torch.tools.colmap_scene import blender_poses, pinhole, point_cloud_u8, write_sparse

    shutil.rmtree(FLAGSHIP_JPG, ignore_errors=True)
    os.makedirs(os.path.join(FLAGSHIP_JPG, "images"))
    src = os.path.join(ROOT, "data", "flagship800")
    images, fovx = [], None
    for split in ("train", "test"):
        fovx, poses = blender_poses(src, split)
        for stem, w2c in poses:
            rgb = composite_background(read_png(os.path.join(src, split, stem + ".png")), False)
            name = f"{split}_{stem}.jpg"
            Image.fromarray(rgb).save(os.path.join(FLAGSHIP_JPG, "images", name), "JPEG", quality=95,
                                      subsampling=2)
            images.append((name, w2c))
    xyz, rgb = point_cloud_u8(os.path.join(src, "points3d.ply"))
    write_sparse(FLAGSHIP_JPG, pinhole(800, 800, fovx), images, xyz, rgb, binary=True)
    return len(images)


if __name__ == "__main__":
    print(len(write_cases()), "cases")
    print(write_flagship_jpg(), "flagship views")
