"""JPEG decoding, equal bit for bit to what PIL returns.

PIL opens a JPEG with libjpeg-turbo at its defaults, and every stage of
that decode is integer arithmetic, so the port can match it exactly:

- the Huffman entropy decode, DC prediction reset at every restart marker;
  for a progressive file the four scan kinds of `jdphuff.c` (DC first and
  refine, AC first and refine with their end-of-band runs), the run reset
  at every restart marker too;
- for a progressive file whose scans leave some of the first ten
  coefficients not fully known, libjpeg's inter-block smoothing
  (`jdcoefct.c`, `decompress_smooth_data`, on by default) before the
  IDCT: `smooth_plain`;
- dequantisation and the "islow" integer IDCT (`jidctint.c`, CONST_BITS
  13, PASS1_BITS 2) as libjpeg-turbo's SIMD version computes it, the one
  PIL runs on x86-64: 16-bit lanes for the dequantised coefficients and
  two of the sums, pass 1 saturated to 16 bits, the samples clamped to
  0..255 after the +128 level shift. It equals `jidctint.c` on every
  block an encoder writes; the two part only on blocks far outside the
  sample range, which zero-filled data can leave;
- chroma upsampling with fancy upsampling on (`jdsample.c`): the triangle
  filters h2v1, h1v2 and h2v2 with their rounding biases and the edge rows
  and columns replicated, plain replication for a component 2 or fewer
  samples wide and for other integral ratios (4:1:1);
- YCbCr to RGB with the tables of `jdcolor.c` (SCALEBITS 16).

Supported: SOF0 and SOF1 (sequential Huffman) and SOF2 (progressive
Huffman), 8-bit samples, one component (PIL's mode "L", returned as (H,
W)) or three ("RGB", (H, W, 3)), sampling factors 1 to 4, interleaved or
not, DRI and RST0-7, 8- and 16-bit quantisation tables, any Huffman
tables, a table redefined between scans; APPn and COM segments are
skipped (PIL applies no EXIF rotation or ICC profile on open). A
progressive scan is checked as `jdphuff.c` checks it (a DC scan has Ss =
Se = 0, an AC scan one component and 1 <= Ss <= Se <= 63, a refinement Al
= Ah - 1, Al at most 13); a scan that does not continue the one before it
on a coefficient is decoded, as libjpeg decodes it after a warning. Where
a progressive scan's data ends early (a marker comes before its last
MCU), the MCU that ran out is completed with zero bits and nothing more
is decoded up to the next restart marker, as libjpeg does; a bit string
that is no Huffman code there takes 17 bits and decodes as symbol 0. A
lossless, hierarchical or arithmetic-coded file, 12-bit samples, four
components (Adobe CMYK/YCCK) and a truncated file (no EOI after the last
scan) raise a ValueError that names the file and the marker.

How the smoothing was matched (no libjpeg source is in the repository):
its structure and its 5x5 DC kernels, rounding, clamp and the choice of
kernels by coef_bits were written from libjpeg-turbo's
`decompress_smooth_data` and then held to PIL (Pillow 12.1, libjpeg-turbo
3.1) on files that stop after each scan of PIL's own script and on
drawn scan scripts (`tests/jpeg_fixtures.py::random_script`); the
sweeps over widths and heights 1-60 at every sampling found the two
points where a guess was wrong: the neighbouring columns are the edge
column repeated (`_smooth_cols`), and the rows follow libjpeg's count
of the last iMCU row, which for a component with v = 2 and an odd
number of block rows reads the padding row below (`_smooth_rows`).
Files whose last scan's data ends early fixed the row rule for the
earlier coef_bits (rows past the last iMCU row begun before the data
ran out), and blocks of zero-filled data far out of range fixed the
IDCT's 16-bit lanes above. `tests/test_torch_jpeg.py` keeps those draws.

This is the plain version: marker parsing, a table-driven Python Huffman
loop (about a microsecond per coefficient, so meant for small images and
for checks), and the smoothing, IDCT, upsampling and colour conversion
vectorised over all blocks in numpy with the C expressions. `ops/jpeg.py`
runs the same stages in native host code (`csrc/jpeg.cu`) on the parse
made here.
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
_NATURAL80 = ZIGZAG.tolist() + [63] * 16  # jpeg_natural_order and its padding
_ZZ_INDEX = np.argsort(ZIGZAG)  # natural position -> zigzag position

_UNSUPPORTED = {
    0xC3: "lossless", 0xC5: "differential sequential",
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
    ss: int = 0  # spectral selection, zigzag positions ss..se
    se: int = 63
    ah: int = 0  # successive approximation: bits known before, and the point transform
    al: int = 0


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
    progressive: bool = False


def _fail(name: str, what: str, marker: Optional[int] = None) -> ValueError:
    where = f" (marker 0xFF{marker:02X})" if marker is not None else ""
    return ValueError(f"{name}: {what}{where}; the port decodes baseline, extended sequential "
                      "and progressive Huffman JPEG with 8-bit samples and 1 or 3 components")


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
        if marker in (0xC0, 0xC1, 0xC2):
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
            frame = JpegFrame(name, width, height, comps, progressive=marker == 0xC2)
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
            if not 1 <= ns <= 4 or len(seg) != 4 + 2 * ns:
                raise _fail(name, "a bad scan header", marker)
            ss, se, ahl = seg[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahl >> 4, ahl & 15
            if frame.progressive:
                _check_progression(name, ns, ss, se, ah, al)
            elif ss != 0 or se != 63 or ahl != 0:
                raise _fail(name, "a spectral-selection scan is not sequential", marker)
            # jdphuff.c builds only the tables a progressive scan reads
            need_dc = not frame.progressive or (ss == 0 and ah == 0)
            need_ac = not frame.progressive or ss > 0
            ids = [c.ident for c in frame.components]
            comps, dcs, acs = [], [], []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                if cid not in ids:
                    raise _fail(name, f"scan names unknown component {cid}", marker)
                ci = ids.index(cid)
                if ci in comps:
                    raise _fail(name, f"scan names component {cid} twice", marker)
                comp = frame.components[ci]
                if comp.qtable is None:
                    if comp.tq not in qtables:
                        raise _fail(name, f"no quantisation table {comp.tq}", marker)
                    comp.qtable = qtables[comp.tq].copy()
                if (need_dc and (t >> 4) not in dc_tables) or (need_ac and (t & 15) not in ac_tables):
                    raise _fail(name, "scan uses an undefined Huffman table", marker)
                if need_dc and max(dc_tables[t >> 4].values, default=0) > 15:
                    raise _fail(name, "bad Huffman table (a DC symbol over 15)", marker)
                comps.append(ci)
                dcs.append(dc_tables[t >> 4] if need_dc else None)
                acs.append(ac_tables[t & 15] if need_ac else None)
            m = _SEGMENT_END.search(data, pos)
            if m is None:
                raise _fail(name, "truncated file: the scan data has no end marker", marker)
            frame.scans.append(Scan(comps, dcs, acs, restart, data[pos:m.start()], ss, se, ah, al))
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


def _check_progression(name: str, ns: int, ss: int, se: int, ah: int, al: int) -> None:
    """start_pass_phuff_decoder's checks (JERR_BAD_PROGRESSION)."""
    if ss == 0:
        bad = se != 0
    else:
        bad = ss > se or se > 63 or ns != 1
    if ah != 0 and al != ah - 1:
        bad = True
    if bad or al > 13:
        raise _fail(name, f"a bad progression: Ss={ss} Se={se} Ah={ah} Al={al}", 0xDA)


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


def _restart_segments(scan: Scan, n_mcus: int, name: str, progressive: bool = False) -> List[Optional[bytes]]:
    """The scan's restart intervals, unstuffed. In a progressive scan the
    intervals after the data's end are None: libjpeg (jdmarker.c,
    jpeg_resync_to_restart) leaves the next marker unread and decodes
    them as empty."""
    parts = _RESTART.split(scan.data) if scan.restart_interval else [scan.data]
    want = _ceil_div(n_mcus, scan.restart_interval) if scan.restart_interval else 1
    if len(parts) < want and not progressive:
        raise ValueError(f"{name}: corrupt JPEG: {len(parts)} restart intervals, {want} expected")
    return [_STUFFED.sub(b"\xff", p) for p in parts[:want]] + [None] * (want - len(parts))


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


# zero bits fed past the end of a segment, as libjpeg feeds them: enough for
# one refinement MCU (63 codes of up to 16 bits, a sign and 63 correction bits)
_ZERO_PAD = bytes(320)


def decode_progressive_scan_plain(frame: JpegFrame, scan: Scan, coefs: List[np.ndarray]) -> Optional[int]:
    """Entropy-decode one progressive scan into the coefficient arrays:
    jdphuff.c's decode_mcu_DC_first, _DC_refine, _AC_first and _AC_refine.
    A DC scan touches coefficient 0 of each block, an AC scan the band
    ss..se (zigzag) of one component's blocks_w x blocks_h blocks. A bit
    string that is no code takes 17 bits and decodes as symbol 0, as
    jpeg_huff_decode fakes it. Returns the last iMCU row begun before the
    data ran out (None: none)."""
    mcus_w, mcus_h, blocks = scan_layout(frame, scan)
    n_mcus = mcus_w * mcus_h
    interval = scan.restart_interval or n_mcus
    segments = _restart_segments(scan, n_mcus, frame.name, progressive=True)
    ss, se, ah, al = scan.ss, scan.se, scan.ah, scan.al
    if ss == 0:  # DC: coefficient 0 of every block of the MCU
        vals = [c[:, :, 0].reshape(-1).tolist() for c in coefs]
        dc_luts = [t.lut().tolist() if t is not None else None for t in scan.dc]
        plan = []
        for k, ci, by, bx in blocks:
            c = frame.components[ci]
            one = len(blocks) == 1
            plan.append((k, ci, by, bx, c.alloc_w, dc_luts[k], 1 if one else c.v, 1 if one else c.h))
    else:  # AC: one component, its band in zigzag order
        ci = scan.comps[0]
        comp = frame.components[ci]
        natural = ZIGZAG[ss:se + 1]
        band = coefs[ci][:, :, natural].reshape(-1).tolist()
        nb = se - ss + 1
        # a run past the band writes jpeg_natural_order[k] all the same (its
        # 16 extra entries are 63): kept aside and written after the band
        slot = [int(_ZZ_INDEX[_NATURAL80[k]]) - ss if ss <= _ZZ_INDEX[_NATURAL80[k]] <= se else None
                for k in range(80)]
        outside = []
        alut = scan.ac[0].lut().tolist()
        aw = comp.alloc_w
    p1, m1 = 1 << al, -1 << al
    # the first MCU of each iMCU row: libjpeg counts a row as good
    # (master->last_good_iMCU_row) when the data had not run out before it
    rows_per_imcu = frame.components[scan.comps[0]].v if len(blocks) == 1 else 1
    row_starts = {i * rows_per_imcu * mcus_w: i for i in range(_ceil_div(mcus_h, rows_per_imcu))}
    last_good = None
    short = False  # libjpeg's insufficient_data
    for si, seg in enumerate(segments):
        if seg is None:  # the restart marker is missing: nothing resets the flag
            seg = b""
        else:
            short = False
        buf = seg + _ZERO_PAD
        nbits = 8 * len(seg)
        pos = 0
        pred = [0] * len(scan.comps)
        eobrun = 0
        for m in range(si * interval, min((si + 1) * interval, n_mcus)):
            if short:
                continue
            if m in row_starts:
                last_good = row_starts[m]
            my, mx = divmod(m, mcus_w)
            if ss == 0 and ah == 0:  # DC first
                for k, ci, by, bx, aw_, dlut, cv, ch in plan:
                    p = pos >> 3
                    e = dlut[(((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2]) >> (8 - (pos & 7))) & 0xFFFF]
                    if e == 0:
                        e = 17 << 8
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
                    vals[ci][(my * cv + by) * aw_ + mx * ch + bx] = _wrap16(pred[k] << al)
            elif ss == 0:  # DC refine: one bit a block
                for k, ci, by, bx, aw_, dlut, cv, ch in plan:
                    if (buf[pos >> 3] >> (7 - (pos & 7))) & 1:
                        i = (my * cv + by) * aw_ + mx * ch + bx
                        vals[ci][i] = _wrap16(vals[ci][i] | p1)
                    pos += 1
            elif ah == 0:  # AC first
                if eobrun:
                    eobrun -= 1
                else:
                    base = (my * aw + mx) * nb
                    k = ss
                    while k <= se:
                        p = pos >> 3
                        e = alut[(((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2]) >> (8 - (pos & 7))) & 0xFFFF]
                        if e == 0:
                            e = 17 << 8
                        pos += e >> 8
                        rs = e & 0xFF
                        r, s = rs >> 4, rs & 15
                        if s:
                            k += r
                            p = pos >> 3
                            v = ((((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2]) >> (24 - s - (pos & 7)))
                                 & ((1 << s) - 1))
                            pos += s
                            if v < (1 << (s - 1)):
                                v += 1 - (1 << s)
                            j = slot[k]
                            if j is not None:
                                band[base + j] = _wrap16(v << al)
                            else:
                                outside.append((my, mx, _NATURAL80[k], _wrap16(v << al)))
                        elif r == 15:
                            k += 15
                        else:
                            eobrun = 1 << r
                            if r:
                                p = pos >> 3
                                eobrun += ((((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2])
                                            >> (24 - r - (pos & 7))) & ((1 << r) - 1))
                                pos += r
                            eobrun -= 1
                            break
                        k += 1
            else:  # AC refine
                base = (my * aw + mx) * nb
                k = ss
                if eobrun == 0:
                    while k <= se:
                        p = pos >> 3
                        e = alut[(((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2]) >> (8 - (pos & 7))) & 0xFFFF]
                        if e == 0:
                            e = 17 << 8
                        pos += e >> 8
                        rs = e & 0xFF
                        r, s = rs >> 4, rs & 15
                        if s:  # a newly nonzero coefficient: its sign
                            s = p1 if (buf[pos >> 3] >> (7 - (pos & 7))) & 1 else m1
                            pos += 1
                        elif r != 15:
                            eobrun = 1 << r
                            if r:
                                p = pos >> 3
                                eobrun += ((((buf[p] << 16) | (buf[p + 1] << 8) | buf[p + 2])
                                            >> (24 - r - (pos & 7))) & ((1 << r) - 1))
                                pos += r
                            break
                        # correction bits on the nonzero coefficients passed,
                        # r zero-history ones skipped
                        while True:
                            j = base + k - ss
                            c = band[j]
                            if c:
                                if (buf[pos >> 3] >> (7 - (pos & 7))) & 1 and not c & p1:
                                    band[j] = c + p1 if c >= 0 else c + m1
                                pos += 1
                            else:
                                r -= 1
                                if r < 0:
                                    break
                            k += 1
                            if k > se:
                                break
                        if s:
                            j = slot[k]
                            if j is not None:
                                band[base + j] = s
                            else:
                                outside.append((my, mx, _NATURAL80[k], s))
                        k += 1
                if eobrun > 0:
                    while k <= se:
                        j = base + k - ss
                        c = band[j]
                        if c:
                            if (buf[pos >> 3] >> (7 - (pos & 7))) & 1 and not c & p1:
                                band[j] = c + p1 if c >= 0 else c + m1
                            pos += 1
                        k += 1
                    eobrun -= 1
            # the data ended inside this MCU: libjpeg completes it with
            # zero bits and decodes nothing more until a restart marker
            short = pos > nbits
    if ss == 0:
        for c, v in zip(coefs, vals):
            c[:, :, 0] = np.asarray(v, np.int16).reshape(c.shape[:2])
    else:
        coefs[ci][:, :, natural] = np.asarray(band, np.int16).reshape(comp.alloc_h, comp.alloc_w, nb)
        for my, mx, at, v in outside:
            coefs[ci][my, mx, at] = v
    return last_good


def coefficient_bits(frame: JpegFrame) -> np.ndarray:
    """(2, components, 64) int: libjpeg's coef_bits after the last scan, the
    low bits still unknown per zigzag coefficient (-1: never coded), and
    its "previous" copy, which start_pass_phuff_decoder takes of
    coefficients min(Ss, 1)..max(Se, 9) of each component a scan codes,
    before the scan (0 in the file's first scan; -1 throughout when the
    file has one scan, as smoothing_ok latches it)."""
    bits = np.full((2, len(frame.components), 64), -1, np.int64)
    for n, scan in enumerate(frame.scans):
        for ci in scan.comps:
            lo, hi = min(scan.ss, 1), max(scan.se, 9) + 1
            bits[1, ci, lo:hi] = bits[0, ci, lo:hi] if n else 0
            bits[0, ci, scan.ss:scan.se + 1] = scan.al
    if len(frame.scans) == 1:
        bits[1] = -1
    return bits


def alloc_coefficients(frame: JpegFrame) -> List[np.ndarray]:
    return [np.zeros((c.alloc_h, c.alloc_w, 64), np.int16) for c in frame.components]


# ------------------------------------------------------------------ IDCT

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _wrap16(x):
    """The low 16 bits, signed: (JCOEF) x, and the SIMD IDCT's 16-bit lanes."""
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def _idct_1d(v: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One pass of the islow IDCT on int64 inputs v[0..7], as libjpeg-turbo's
    SIMD version computes it: jidctint.c's products regrouped, in0 +/- in4
    and the odd part's z3 = in7 + in3, z4 = in5 + in1 summed in 16-bit
    lanes, outputs DESCALEd by shift."""
    z2, z3 = v[2], v[6]
    tmp2 = z2 * FIX_0_541196100 + z3 * (FIX_0_541196100 - FIX_1_847759065)
    tmp3 = z2 * (FIX_0_541196100 + FIX_0_765366865) + z3 * FIX_0_541196100
    tmp0 = _wrap16(v[0] + v[4]) << CONST_BITS
    tmp1 = _wrap16(v[0] - v[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
    z3, z4 = _wrap16(t0 + t2), _wrap16(t1 + t3)
    z3, z4 = (z3 * (FIX_1_175875602 - FIX_1_961570560) + z4 * FIX_1_175875602,
              z3 * FIX_1_175875602 + z4 * (FIX_1_175875602 - FIX_0_390180644))
    o0 = t0 * (FIX_0_298631336 - FIX_0_899976223) + t3 * -FIX_0_899976223 + z3
    o1 = t1 * (FIX_2_053119869 - FIX_2_562915447) + t2 * -FIX_2_562915447 + z4
    o2 = t1 * -FIX_2_562915447 + t2 * (FIX_3_072711026 - FIX_2_562915447) + z3
    o3 = t0 * -FIX_0_899976223 + t3 * (FIX_1_501321110 - FIX_0_899976223) + z4
    r = 1 << (shift - 1)
    return [(a + r) >> shift for a in (
        tmp10 + o3, tmp11 + o2, tmp12 + o1, tmp13 + o0,
        tmp13 - o0, tmp12 - o1, tmp11 - o2, tmp10 - o3)]


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """(..., 64) int16 coefficients -> (..., 8, 8) uint8 samples: the
    dequantised coefficients in 16 bits, pass 1's outputs saturated to 16
    bits (wrapped, for a block with only its first row nonzero) and the
    samples clamped to 0..255 (+128), as the SIMD IDCT computes them
    (jidctint.c's range-limit table wraps past +-512 instead; no block an
    encoder writes comes near either)."""
    shape = coefs.shape[:-1]
    c = coefs.reshape(-1, 8, 8).astype(np.int64)
    x = _wrap16(c * _wrap16(qtable.reshape(8, 8).astype(np.int64)))
    cols = _idct_1d([x[:, k, :] for k in range(8)], CONST_BITS - PASS1_BITS)
    ws = np.clip(np.stack(cols, axis=1), -0x8000, 0x7FFF)
    # a block whose rows 1-7 are zero takes the SIMD shortcut: pass 1 is
    # the first row << PASS1_BITS, in 16 bits
    flat = ~c[:, 1:, :].any(axis=(1, 2))
    ws[flat] = _wrap16(x[flat, :1, :] << PASS1_BITS)
    rows = _idct_1d([ws[:, :, k] for k in range(8)], CONST_BITS + PASS1_BITS + 3)
    out = np.clip(np.stack(rows, axis=2), -128, 127) + 128
    return out.astype(np.uint8).reshape(shape + (8, 8))


def component_plane(frame: JpegFrame, ci: int, coefs: np.ndarray) -> np.ndarray:
    """The component's decoded samples, (height, width) uint8."""
    c = frame.components[ci]
    blocks = idct_islow(coefs, c.qtable)  # (alloc_h, alloc_w, 8, 8)
    plane = blocks.transpose(0, 2, 1, 3).reshape(c.alloc_h * 8, c.alloc_w * 8)
    return plane[:c.height, :c.width]


# ------------------------------------------------------- block smoothing

# natural positions of zigzag coefficients 0..9, the ones smoothing estimates
SMOOTH_POS = ZIGZAG[:10]
# decompress_smooth_data's 5x5 DC kernels, rows top to bottom, per estimated
# zigzag coefficient 1..9 and the DC itself (0): with no AC coefficient
# coded yet ("change_dc"), and otherwise (estimates of 1..5 only)
_K_DC = {
    1: [[-1, -1, 0, 1, 1], [-3, 13, 0, -13, 3], [-3, 38, 0, -38, 3], [-3, 13, 0, -13, 3], [-1, -1, 0, 1, 1]],
    2: [[-1, -3, -3, -3, -1], [-1, 13, 38, 13, -1], [0, 0, 0, 0, 0], [1, -13, -38, -13, 1], [1, 3, 3, 3, 1]],
    3: [[0, 0, 1, 0, 0], [0, 2, 7, 2, 0], [0, -5, -14, -5, 0], [0, 2, 7, 2, 0], [0, 0, 1, 0, 0]],
    4: [[-1, 0, 0, 0, 1], [0, 9, 0, -9, 0], [0, 0, 0, 0, 0], [0, -9, 0, 9, 0], [1, 0, 0, 0, -1]],
    5: [[0, 0, 0, 0, 0], [0, 2, -5, 2, 0], [1, 7, -14, 7, 1], [0, 2, -5, 2, 0], [0, 0, 0, 0, 0]],
    6: [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, 2, 0, -2, 0], [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],
    7: [[0, 0, 0, 0, 0], [0, 1, -3, 1, 0], [0, 0, 0, 0, 0], [0, -1, 3, -1, 0], [0, 0, 0, 0, 0]],
    8: [[0, 0, 0, 0, 0], [0, 1, 0, -1, 0], [0, -3, 0, 3, 0], [0, 1, 0, -1, 0], [0, 0, 0, 0, 0]],
    9: [[0, 0, 0, 0, 0], [0, 1, 2, 1, 0], [0, 0, 0, 0, 0], [0, -1, -2, -1, 0], [0, 0, 0, 0, 0]],
    0: [[-2, -6, -8, -6, -2], [-6, 6, 42, 6, -6], [-8, 42, 152, 42, -8], [-6, 6, 42, 6, -6],
        [-2, -6, -8, -6, -2]],
}
_K_AC = {
    1: [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-7, 50, 0, -50, 7], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
    2: [[0, 0, -7, 0, 0], [0, 0, 50, 0, 0], [0, 0, 0, 0, 0], [0, 0, -50, 0, 0], [0, 0, 7, 0, 0]],
    3: [[0, 0, -1, 0, 0], [0, 0, 13, 0, 0], [0, 0, -24, 0, 0], [0, 0, 13, 0, 0], [0, 0, -1, 0, 0]],
    4: [[0, -1, 0, 1, 0], [-1, 10, 0, -10, 1], [0, 0, 0, 0, 0], [1, -10, 0, 10, -1], [0, 1, 0, -1, 0]],
    5: [[0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [-1, 13, -24, 13, -1], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]],
}


def smoothing_wanted(frame: JpegFrame, bits: np.ndarray) -> bool:
    """jdcoefct.c::smoothing_ok on `coefficient_bits`: a progressive file,
    every component's DC coded, DC and the first nine AC quantisers
    nonzero, and some of those nine coefficients not fully known in some
    component."""
    if not frame.progressive:
        return False
    for ci, c in enumerate(frame.components):
        if (c.qtable[SMOOTH_POS] == 0).any() or bits[0, ci, 0] < 0:
            return False
    return bool((bits[0, :, 1:10] != 0).any())


def _smooth_rows(c: Component, total_rows: int) -> np.ndarray:
    """(output block rows, 5): each output row's block rows two above to two
    below as decompress_smooth_data picks them (edges repeat the row; the
    position in the image counts the last iMCU row's short height)."""
    out = []
    for imcu in range(total_rows):
        block_rows = c.v if imcu < total_rows - 1 else (c.blocks_h % c.v or c.v)
        n = block_rows * total_rows
        for b in range(block_rows):
            r, i = imcu * c.v + b, imcu * block_rows + b
            prev = r - 1 if i > 0 else r
            nxt = r + 1 if i < n - 1 else r
            out.append((r - 2 if i > 1 else prev, prev, r, nxt, r + 2 if i < n - 2 else nxt))
    return np.array(out, np.int64).reshape(-1, 5)


def _smooth_cols(width: int) -> np.ndarray:
    """(width, 5): each block's columns two left to two right, the edge
    column repeated."""
    return np.clip(np.arange(width)[:, None] + np.arange(-2, 3)[None, :], 0, width - 1)


def _estimate(num: np.ndarray, q: int, al: int, clamp: bool = True) -> np.ndarray:
    """pred = round(num / (q * 256)) away from zero at halves, its
    magnitude capped below 2^al when al > 0 bits are unknown."""
    a = (q * 128 + np.abs(num)) // (q * 256)
    if clamp and al > 0:
        a = np.minimum(a, (1 << al) - 1)
    return np.where(num >= 0, a, -a)


def _smooth_estimates(c: Component, ws: np.ndarray, dcs: list, bits: np.ndarray) -> np.ndarray:
    """The blocks `ws` with the estimates of one coef_bits latch applied."""
    q = c.qtable.astype(np.int64)
    ws = ws.copy()
    change_dc = bool((bits[1:10] == -1).all())
    kernels = _K_DC if change_dc else _K_AC
    for k in range(1, 10 if change_dc else 6):
        pos = SMOOTH_POS[k]
        if bits[k] == 0:
            continue
        num = q[0] * sum(w * dcs[a][b] for a, row in enumerate(kernels[k]) for b, w in enumerate(row) if w)
        ws[..., pos] = np.where(ws[..., pos] == 0, _estimate(num, q[pos], bits[k]), ws[..., pos])
    if change_dc:
        num = q[0] * sum(w * dcs[a][b] for a, row in enumerate(_K_DC[0]) for b, w in enumerate(row))
        ws[..., 0] = _estimate(num, q[0], 0, clamp=False)
    return ws


def smooth_component(c: Component, coef: np.ndarray, bits: np.ndarray, prev_bits: np.ndarray,
                     total_rows: int, last_good: int) -> np.ndarray:
    """decompress_smooth_data on one component's (alloc_h, alloc_w, 64)
    coefficients, with its coef_bits latch, or the previous latch in the
    iMCU rows past `last_good`; returns the coefficients the IDCT sees
    (blocks outside the image unchanged)."""
    rows, cols = _smooth_rows(c, total_rows), _smooth_cols(c.blocks_w)
    dc = coef[:, :, 0].astype(np.int64)
    # dcs[a][b]: the DC two rows up (a = 0) to two down, two left (b = 0) to two right
    dcs = [[dc[rows[:, a][:, None], cols[:, b][None, :]] for b in range(5)] for a in range(5)]
    ws = coef[rows[:, 2]][:, :c.blocks_w].astype(np.int64)
    out_ws = _smooth_estimates(c, ws, dcs, bits)
    late = rows[:, 2] // c.v > last_good
    if late.any():
        out_ws[late] = _smooth_estimates(c, ws, dcs, prev_bits)[late]
    out = coef.copy()
    out[rows[:, 2], :c.blocks_w] = _wrap16(out_ws)  # (JCOEF)
    return out


def smooth_plain(frame: JpegFrame, coefs: List[np.ndarray], bits: np.ndarray,
                 last_good: int) -> List[np.ndarray]:
    """The coefficients the IDCT sees: smoothed where libjpeg smooths."""
    if not smoothing_wanted(frame, bits):
        return coefs
    return [smooth_component(c, coefs[ci], bits[0, ci], bits[1, ci], frame.mcuy, last_good)
            for ci, c in enumerate(frame.components)]


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
    if not frame.progressive:
        for scan in frame.scans:
            decode_scan_plain(frame, scan, coefs)
        return reconstruct_plain(frame, coefs)
    last_good = 0  # master->last_good_iMCU_row: the last scan's, where it completed one
    for scan in frame.scans:
        good = decode_progressive_scan_plain(frame, scan, coefs)
        if good is not None:
            last_good = good
    return reconstruct_plain(frame, smooth_plain(frame, coefs, coefficient_bits(frame), last_good))


def read_jpeg(path: str) -> np.ndarray:
    """(H, W, 3) or (H, W) uint8 of a JPEG file, as np.asarray(PIL.Image.open(path))."""
    with open(path, "rb") as f:
        return decode_plain(f.read(), path)
