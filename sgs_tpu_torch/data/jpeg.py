"""Baseline JPEG decoding, equal bit for bit to what PIL returns.

PIL opens a JPEG with libjpeg(-turbo) at its defaults, and every stage of
that decode is integer arithmetic, so the port can match it exactly:

- the Huffman entropy decode, DC prediction reset at every restart marker;
- dequantisation and the "islow" integer IDCT of `jidctint.c`
  (CONST_BITS 13, PASS1_BITS 2, the range-limit table), with the +128
  level shift folded into that table;
- chroma upsampling with fancy upsampling on (`jdsample.c`): the triangle
  filters h2v1, h1v2 and h2v2 with their rounding biases and the edge rows
  and columns replicated, plain replication for a component 2 or fewer
  samples wide and for other integral ratios (4:1:1);
- YCbCr to RGB with the tables of `jdcolor.c` (SCALEBITS 16).

Supported: SOF0 and SOF1 (sequential Huffman), 8-bit samples, one
component (PIL's mode "L", returned as (H, W)) or three ("RGB", (H, W,
3)), sampling factors 1 to 4, interleaved or not, DRI and RST0-7, 8- and
16-bit quantisation tables, any Huffman tables; APPn and COM segments are
skipped (PIL applies no EXIF rotation or ICC profile on open). A
progressive, lossless, hierarchical or arithmetic-coded file, 12-bit
samples, four components (Adobe CMYK/YCCK) and a truncated file raise a
ValueError that names the file and the marker.

This is the plain version: marker parsing, a table-driven Python Huffman
loop (about a microsecond per coefficient, so meant for small images and
for checks), and the IDCT, upsampling and colour conversion vectorised
over all blocks in numpy with the C expressions. `ops/jpeg.py` runs the
same stages in native host code (`csrc/jpeg.cu`) on the parse made here.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], np.int32)  # zigzag position -> natural (row-major) position

_UNSUPPORTED = {
    0xC2: "progressive DCT", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless", 0xCC: "arithmetic coding conditioning",
}

# The end of an entropy-coded segment: a run of 0xFF and a byte that is not
# a stuffed zero, another fill byte or a restart marker.
_SEGMENT_END = re.compile(rb"\xff+[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")
_STUFFED = re.compile(rb"\xff+\x00")


@dataclass
class Component:
    ident: int
    h: int
    v: int
    tq: int
    qtable: Optional[np.ndarray] = None  # (64,) natural order, latched at its first scan
    width: int = 0  # downsampled_width
    height: int = 0
    blocks_w: int = 0  # width_in_blocks (non-interleaved scans cover these)
    blocks_h: int = 0
    alloc_w: int = 0  # blocks allocated: whole MCUs
    alloc_h: int = 0


@dataclass
class HuffmanTable:
    bits: bytes  # counts of codes of length 1..16
    values: bytes
    _lut: Optional[np.ndarray] = None

    def lut(self) -> np.ndarray:
        """(65536,) int32: for a 16-bit window, symbol | code length << 8
        (0 where no code starts the window)."""
        if self._lut is None:
            lut = np.zeros(65536, np.int32)
            code, k = 0, 0
            for length in range(1, 17):
                for _ in range(self.bits[length - 1]):
                    lo = code << (16 - length)
                    lut[lo:lo + (1 << (16 - length))] = self.values[k] | (length << 8)
                    code += 1
                    k += 1
                code <<= 1
            self._lut = lut
        return self._lut


@dataclass
class Scan:
    comps: List[int]  # component indices
    dc: List[HuffmanTable]
    ac: List[HuffmanTable]
    restart_interval: int
    data: bytes  # entropy-coded bytes, stuffing and restart markers included


@dataclass
class JpegFrame:
    name: str
    width: int
    height: int
    components: List[Component]
    scans: List[Scan] = field(default_factory=list)
    color: str = "ycc"  # "gray", "ycc" or "rgb"
    hmax: int = 1
    vmax: int = 1
    mcux: int = 0
    mcuy: int = 0


def _fail(name: str, what: str, marker: Optional[int] = None) -> ValueError:
    where = f" (marker 0xFF{marker:02X})" if marker is not None else ""
    return ValueError(f"{name}: {what}{where}; the port decodes baseline and extended "
                      "sequential Huffman JPEG with 8-bit samples and 1 or 3 components")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def parse_jpeg(data: bytes, name: str = "<bytes>") -> JpegFrame:
    """Markers, tables and the scans' entropy-coded bytes of a JPEG file."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file (no SOI marker)")
    pos = 2
    qtables: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, HuffmanTable] = {}
    ac_tables: Dict[int, HuffmanTable] = {}
    restart = 0
    frame: Optional[JpegFrame] = None
    jfif = False
    adobe_transform: Optional[int] = None
    n = len(data)
    while True:
        while pos < n and data[pos] == 0xFF and pos + 1 < n and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes before a marker
        if pos + 2 > n:
            raise _fail(name, "truncated file: it ends before the EOI marker")
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:  # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue  # a stray RSTn or TEM has no length
        if pos + 2 > n:
            raise _fail(name, "truncated file", marker)
        length = (data[pos] << 8) | data[pos + 1]
        seg = data[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise _fail(name, "truncated file", marker)
        pos += length
        if marker in _UNSUPPORTED:
            raise _fail(name, f"{_UNSUPPORTED[marker]} JPEG is not decoded", marker)
        if marker in (0xC0, 0xC1):
            if frame is not None:
                raise _fail(name, "a second frame header", marker)
            precision, height, width, nc = seg[0], (seg[1] << 8) | seg[2], (seg[3] << 8) | seg[4], seg[5]
            if precision != 8:
                raise _fail(name, f"{precision}-bit samples are not decoded", marker)
            if nc not in (1, 3):
                kind = "Adobe CMYK/YCCK (4 components)" if nc == 4 else f"{nc} components"
                raise _fail(name, f"{kind} is not decoded", marker)
            if width == 0 or height == 0:
                raise _fail(name, "a zero image dimension (DNL) is not decoded", marker)
            comps = []
            for i in range(nc):
                c, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                h, v = hv >> 4, hv & 15
                if not (1 <= h <= 4 and 1 <= v <= 4) or tq > 3:
                    raise _fail(name, f"bad sampling factors {h}x{v} or table {tq}", marker)
                comps.append(Component(c, h, v, tq))
            frame = JpegFrame(name, width, height, comps)
        elif marker == 0xC4:
            p = 0
            while p < len(seg):
                tc, th = seg[p] >> 4, seg[p] & 15
                bits = seg[p + 1:p + 17]
                count = sum(bits)
                table = HuffmanTable(bytes(bits), bytes(seg[p + 17:p + 17 + count]))
                if tc > 1 or th > 3 or len(bits) != 16 or len(table.values) != count:
                    raise _fail(name, "bad Huffman table", marker)
                (ac_tables if tc else dc_tables)[th] = table
                p += 17 + count
        elif marker == 0xDB:
            p = 0
            while p < len(seg):
                pq, tq = seg[p] >> 4, seg[p] & 15
                if pq:
                    raw = np.frombuffer(seg[p + 1:p + 129], ">u2").astype(np.int32)
                    p += 129
                else:
                    raw = np.frombuffer(seg[p + 1:p + 65], np.uint8).astype(np.int32)
                    p += 65
                if raw.size != 64 or tq > 3:
                    raise _fail(name, "bad quantisation table", marker)
                table = np.zeros(64, np.int32)
                table[ZIGZAG] = raw
                qtables[tq] = table
        elif marker == 0xDD:
            restart = (seg[0] << 8) | seg[1]
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
        elif marker == 0xDA:
            if frame is None:
                raise _fail(name, "a scan before the frame header", marker)
            ns = seg[0]
            ids = [c.ident for c in frame.components]
            comps, dcs, acs = [], [], []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                if cid not in ids:
                    raise _fail(name, f"scan names unknown component {cid}", marker)
                ci = ids.index(cid)
                comp = frame.components[ci]
                if comp.qtable is None:
                    if comp.tq not in qtables:
                        raise _fail(name, f"no quantisation table {comp.tq}", marker)
                    comp.qtable = qtables[comp.tq].copy()
                if (t >> 4) not in dc_tables or (t & 15) not in ac_tables:
                    raise _fail(name, "scan uses an undefined Huffman table", marker)
                comps.append(ci)
                dcs.append(dc_tables[t >> 4])
                acs.append(ac_tables[t & 15])
            ss, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahl != 0:
                raise _fail(name, "a spectral-selection scan is not sequential", marker)
            m = _SEGMENT_END.search(data, pos)
            if m is None:
                raise _fail(name, "truncated file: the scan data has no end marker", marker)
            frame.scans.append(Scan(comps, dcs, acs, restart, data[pos:m.start()]))
            pos = m.end() - 2
        # APPn, COM and anything else with a length: skipped
    if frame is None or not frame.scans:
        raise _fail(name, "no frame or no scan before EOI")
    frame.hmax = max(c.h for c in frame.components)
    frame.vmax = max(c.v for c in frame.components)
    frame.mcux = _ceil_div(frame.width, 8 * frame.hmax)
    frame.mcuy = _ceil_div(frame.height, 8 * frame.vmax)
    for c in frame.components:
        c.width = _ceil_div(frame.width * c.h, frame.hmax)
        c.height = _ceil_div(frame.height * c.v, frame.vmax)
        c.blocks_w, c.blocks_h = _ceil_div(c.width, 8), _ceil_div(c.height, 8)
        c.alloc_w, c.alloc_h = frame.mcux * c.h, frame.mcuy * c.v
        if c.qtable is None:
            raise _fail(name, f"component {c.ident} is in no scan")
    if len(frame.components) == 1:
        frame.color = "gray"
    elif jfif:
        frame.color = "ycc"
    elif adobe_transform is not None:
        frame.color = "rgb" if adobe_transform == 0 else "ycc"
    else:
        ids = [c.ident for c in frame.components]
        frame.color = "rgb" if ids == [82, 71, 66] else "ycc"
    return frame


def scan_layout(frame: JpegFrame, scan: Scan) -> Tuple[int, int, List[Tuple[int, int, int, int]]]:
    """(MCUs per row, MCU rows, blocks of one MCU as (scan component,
    component index, block row, block column) within the MCU)."""
    if len(scan.comps) == 1:
        c = frame.components[scan.comps[0]]
        return c.blocks_w, c.blocks_h, [(0, scan.comps[0], 0, 0)]
    blocks = []
    for k, ci in enumerate(scan.comps):
        c = frame.components[ci]
        blocks += [(k, ci, by, bx) for by in range(c.v) for bx in range(c.h)]
    if len(blocks) > 10:
        raise _fail(frame.name, f"an MCU of {len(blocks)} blocks (more than 10)", 0xDA)
    return frame.mcux, frame.mcuy, blocks


def _restart_segments(scan: Scan, n_mcus: int, name: str) -> List[bytes]:
    """The scan's restart intervals, unstuffed."""
    parts = _RESTART.split(scan.data) if scan.restart_interval else [scan.data]
    want = _ceil_div(n_mcus, scan.restart_interval) if scan.restart_interval else 1
    if len(parts) < want:
        raise ValueError(f"{name}: corrupt JPEG: {len(parts)} restart intervals, {want} expected")
    return [_STUFFED.sub(b"\xff", p) for p in parts[:want]]


def decode_scan_plain(frame: JpegFrame, scan: Scan, coefs: List[np.ndarray]) -> None:
    """Entropy-decode one scan into the components' (alloc_h, alloc_w, 64)
    int16 coefficient arrays (natural order). The Python Huffman loop."""
    mcus_w, mcus_h, blocks = scan_layout(frame, scan)
    n_mcus = mcus_w * mcus_h
    interval = scan.restart_interval or n_mcus
    segments = _restart_segments(scan, n_mcus, frame.name)
    dc_luts = [t.lut().tolist() for t in scan.dc]
    ac_luts = [t.lut().tolist() for t in scan.ac]
    flat = [c.reshape(-1).tolist() for c in coefs]
    zz = ZIGZAG.tolist()
    plan = []
    for k, ci, by, bx in blocks:
        c = frame.components[ci]
        plan.append((k, ci, by, bx, c.alloc_w, dc_luts[k], ac_luts[k],
                     c.v if len(blocks) > 1 else 1, c.h if len(blocks) > 1 else 1))
    for si, seg in enumerate(segments):
        buf = seg + b"\x00\x00\x00\x00"
        nbits = 8 * len(seg)
        pos = 0
        pred = [0] * len(scan.comps)
        for m in range(si * interval, min((si + 1) * interval, n_mcus)):
            my, mx = divmod(m, mcus_w)
            for k, ci, by, bx, aw, dlut, alut, cv, ch in plan:
                out = flat[ci]
                base = ((my * cv + by) * aw + mx * ch + bx) * 64
                p = pos >> 3
                e = dlut[(((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2]) >> (8 - (pos & 7))) & 0xFFFF]
                if e == 0:
                    raise ValueError(f"{frame.name}: corrupt JPEG: bad Huffman code")
                pos += e >> 8
                s = e & 0xFF
                r = 0
                if s:
                    p = pos >> 3
                    r = ((((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2]) >> (24 - s - (pos & 7)))
                         & ((1 << s) - 1))
                    pos += s
                    if r < (1 << (s - 1)):
                        r += 1 - (1 << s)
                pred[k] += r
                dc = pred[k] & 0xFFFF  # JCOEF is 16 bits
                out[base] = dc - 0x10000 if dc & 0x8000 else dc
                i = 1
                while i < 64:
                    p = pos >> 3
                    e = alut[(((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2]) >> (8 - (pos & 7))) & 0xFFFF]
                    if e == 0:
                        raise ValueError(f"{frame.name}: corrupt JPEG: bad Huffman code")
                    pos += e >> 8
                    rs = e & 0xFF
                    s = rs & 15
                    if s:
                        i += rs >> 4
                        p = pos >> 3
                        r = ((((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2]) >> (24 - s - (pos & 7)))
                             & ((1 << s) - 1))
                        pos += s
                        if r < (1 << (s - 1)):
                            r += 1 - (1 << s)
                        if i < 64:
                            out[base + zz[i]] = r
                        i += 1
                    elif rs == 0xF0:
                        i += 16
                    else:
                        break
            if pos > nbits:
                raise ValueError(f"{frame.name}: corrupt JPEG: premature end of the scan data")
    for c, f in zip(coefs, flat):
        c.reshape(-1)[:] = f


def alloc_coefficients(frame: JpegFrame) -> List[np.ndarray]:
    return [np.zeros((c.alloc_h, c.alloc_w, 64), np.int16) for c in frame.components]


# ------------------------------------------------------------------ IDCT

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _idct_1d(v: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of jpeg_idct_islow on int64 inputs v[0..7]."""
    z2, z3 = v[2], v[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (v[0] + v[4]) << CONST_BITS
    tmp1 = (v[0] - v[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * FIX_1_175875602
    tmp0 = tmp0 * FIX_0_298631336
    tmp1 = tmp1 * FIX_2_053119869
    tmp2 = tmp2 * FIX_3_072711026
    tmp3 = tmp3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    return [_descale(a, shift) for a in (
        tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
        tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3)]


def _idct_range_limit() -> np.ndarray:
    """`range_limit[x & 1023]` of jidctint.c, the +128 shift included."""
    i = np.arange(1024)
    return np.select([i < 128, i < 512, i < 896], [i + 128, 255, 0], i - 896).astype(np.uint8)


IDCT_LIMIT = _idct_range_limit()


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(..., 64) int16 coefficients -> (..., 8, 8) uint8 samples."""
    shape = coefs.shape[:-1]
    x = coefs.reshape(-1, 8, 8).astype(np.int64) * qtable.reshape(8, 8).astype(np.int64)
    cols = _idct_1d([x[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS)
    ws = np.stack(cols, axis=1).astype(np.int32).astype(np.int64)  # wsptr is int
    rows = _idct_1d([ws[:, :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3)
    out = IDCT_LIMIT[np.stack(rows, axis=2) & 1023]
    return out.reshape(shape + (8, 8))


def component_plane(frame: JpegFrame, ci: int, coefs: np.ndarray) -> np.ndarray:
    """The component's decoded samples, (height, width) uint8."""
    c = frame.components[ci]
    blocks = idct_islow(coefs, c.qtable)  # (alloc_h, alloc_w, 8, 8)
    plane = blocks.transpose(0, 2, 1, 3).reshape(c.alloc_h * 8, c.alloc_w * 8)
    return plane[:c.height, :c.width]


# -------------------------------------------------------------- upsampling

def _shift(a: np.ndarray, axis: int, step: int) -> np.ndarray:
    """Neighbour at +step along axis with the edge replicated."""
    n = a.shape[axis]
    idx = np.clip(np.arange(n) + step, 0, n - 1)
    return np.take(a, idx, axis=axis)


def _interleave(a: np.ndarray, b: np.ndarray, axis: int) -> np.ndarray:
    return np.stack([a, b], axis=axis + 1).reshape(
        a.shape[:axis] + (2 * a.shape[axis],) + a.shape[axis + 1:])


def upsample(plane: np.ndarray, fh: int, fv: int, width: int, height: int) -> np.ndarray:
    """jdsample.c with do_fancy_upsampling: (h, w) uint8 -> (height, width)."""
    p = plane.astype(np.int32)
    dw = plane.shape[1]
    if fh == 1 and fv == 1:
        out = p
    elif fh == 2 and fv == 1 and dw > 2:  # h2v1_fancy_upsample
        t = 3 * p
        out = _interleave((t + _shift(p, 1, -1) + 1) >> 2, (t + _shift(p, 1, 1) + 2) >> 2, 1)
    elif fh == 1 and fv == 2:  # h1v2_fancy_upsample
        t = 3 * p
        out = _interleave((t + _shift(p, 0, -1) + 1) >> 2, (t + _shift(p, 0, 1) + 2) >> 2, 0)
    elif fh == 2 and fv == 2 and dw > 2:  # h2v2_fancy_upsample
        t = 3 * p
        rows = _interleave(t + _shift(p, 0, -1), t + _shift(p, 0, 1), 0)  # column sums
        s = 3 * rows
        out = _interleave((s + _shift(rows, 1, -1) + 8) >> 4, (s + _shift(rows, 1, 1) + 7) >> 4, 1)
    else:  # h2v1_upsample, h2v2_upsample, int_upsample: replication
        out = np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)
    return out[:height, :width].astype(np.uint8)


# ------------------------------------------------------------ colour

SCALEBITS, ONE_HALF = 16, 1 << 15


def _fix(x: float) -> int:
    return int(x * (1 << SCALEBITS) + 0.5)


def _color_tables():
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix(1.40200) * x + ONE_HALF) >> SCALEBITS
    cb_b = (_fix(1.77200) * x + ONE_HALF) >> SCALEBITS
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + ONE_HALF
    return cr_r, cb_b, cr_g, cb_g


CR_R, CB_B, CR_G, CB_G = _color_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c::ycc_rgb_convert on uint8 planes -> (H, W, 3) uint8."""
    y = y.astype(np.int64)
    r = y + CR_R[cr]
    g = y + ((CB_G[cb] + CR_G[cr]) >> SCALEBITS)
    b = y + CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def reconstruct_plain(frame: JpegFrame, coefs: List[np.ndarray]) -> np.ndarray:
    planes = []
    for ci, c in enumerate(frame.components):
        if frame.hmax % c.h or frame.vmax % c.v:
            raise _fail(frame.name, "fractional sampling ratios are not decoded")
        plane = component_plane(frame, ci, coefs[ci])
        planes.append(upsample(plane, frame.hmax // c.h, frame.vmax // c.v, frame.width, frame.height))
    if frame.color == "gray":
        return planes[0]
    if frame.color == "rgb":
        return np.stack(planes, axis=-1)
    return ycc_to_rgb(*planes)


def decode_plain(data: bytes, name: str = "<bytes>") -> np.ndarray:
    frame = parse_jpeg(data, name)
    coefs = alloc_coefficients(frame)
    for scan in frame.scans:
        decode_scan_plain(frame, scan, coefs)
    return reconstruct_plain(frame, coefs)


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 3) or (H, W) uint8 of a JPEG file, as np.asarray(PIL.Image.open(path))."""
    with open(path, "rb") as f:
        return decode_plain(f.read(), path)
