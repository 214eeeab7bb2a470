"""The forward-raster experiments: Kernels E, F and G, their wrappers,
plain PyTorch versions and launch counts.

They replace the Pallas kernels of three experiment scripts, which
explored Kernel A's design on the TPU:
- E, `scripts/exp_fwd.py::make_variant`: Kernel A's function on
  field-major rows ((R*REC, CHUNK), `rows.field_major`) by a chunk scan of
  the transmittance products (`hs`, Hillis-Steele), by a log-space
  triangular contraction (`mxu`, on the tensor cores here) or with no
  scan (`nocp`, wrong math by design: it isolates the scan's cost);
- F, `scripts/exp_fwd2.py::make_ablation`: structural ablations on the
  same rows: `empty` (a launch over the same grid whose body returns at
  once), `outonly` (the per-row state copy only) and `alpha` (alpha per
  pair, summed per pixel into column 0), with 8 or 1 state columns;
- G, `scripts/exp_transposed.py::make_transposed`: E's function (`hs` or
  `mxu`) on `rows.pack_rows`' instance-major rows ((R*CHUNK, REC)) as they
  are, with the state written pixels-minor, (R, 8, 256).

Every row of a tile continues the tile's per-pixel state [r, g, b, t_run,
t_final, last_contrib, 0, 0] from the row before and writes it out, as the
TPU kernels do row by row. last_contrib is a 1-based position in the padded
slot array (r * CHUNK + lane + 1), not in the tile's list as Kernel A's
n_contrib is. Inside a row the scan runs past the 1e-4 cut: t_run keeps
falling, inclusion stops; a row is skipped when no pixel of the tile has
t_run >= 1e-4.

Where the port defines what the TPU leaves open:
- the TPU kernels carry their state in scratch from one grid step to the
  next; here each tile's rows are walked by one block, and rows past
  `rows_used` (no tile's) hold the initial state;
- the ablations' TPU scratch is never initialised (their outputs are
  undefined there, NaN in interpret mode). Here F's state is zero at each
  tile's first row; row 0 is a tile's first row, so `exp_ablation`'s
  result is what the TPU computes from a zeroed scratch. `empty` writes
  nothing: the wrapper zeroes row 0, the only row it returns;
- the order of each sum over a row's 64 instances (the colour and the
  alpha sums): a halving tree, v[i] + v[i + h] for h = 32, 16, ..., 1.

On a CUDA tensor each wrapper launches its kernel (`csrc/exp_forward.cu`);
on a CPU tensor it runs the plain version. There is no fallback. hs and
nocp (E and G) and F equal their plain versions bit for bit; mxu does not
(two-term TF32 tensor-core sums of base-2 logarithms against the plain
version's f32 matmul of natural ones; see MXU_ATOL).
"""

from __future__ import annotations

import torch

from sgs_tpu_torch.core.projection import ALPHA_MAX, ALPHA_MIN, TILE, TRANSMITTANCE_EPS
from sgs_tpu_torch.ops.build import INT, PTR, CudaKernel, LaunchCount
from sgs_tpu_torch.ops.rows import CHUNK, REC, TILE_PIXELS, field_major

KERNEL = CudaKernel(
    "exp_forward.cu",
    {"exp_forward_launch": [PTR] * 4 + [INT] * 7 + [PTR] * 2,
     "exp_forward_blocks_per_sm": [INT] * 4},
    extra_flags=("--fmad=false",),
)


E, F, G = LaunchCount("E"), LaunchCount("F"), LaunchCount("G")

MODES = {"hs": 0, "mxu": 1, "nocp": 2, "empty": 3, "outonly": 4, "alpha": 5}
SCANS = ("hs", "mxu", "nocp")
ABLATIONS = ("empty", "outonly", "alpha")
KROWS = (8, 32)
SROWS = 8  # state columns: r, g, b, t_run, t_final, last_contrib, 0, 0
INITIAL = (0.0, 0.0, 0.0, 1.0, 1.0, 0.0, 0.0, 0.0)
# mxu against its plain version, off the pixels at a cut (`near_cut`,
# where an inclusion may flip): the kernel's two-term TF32 sum of 64
# log-transmittances keeps about 22 bits of each term, and it takes them
# in base 2 on the SFU (log2 within 2^-22 absolute for u in [0.5, 1] and
# 2 ulp below, exp2 within 2 ulp), so 2^zc of an included lane's sum
# (|sum| < 14) differs from the f32 matmul's exp by about 1e-6 relative,
# 1.2e-5 if the errors of 64 live lanes all added up: colours, t_run and
# t_final within 2e-5, last_contrib equal.
MXU_ATOL = 2e-5
# The windows of `near_cut`: 0.1% of the transmittance cut, and 1e-5 of
# the alpha cut, both far wider than the rounding of the products (a few
# 1e-7 relative) by which two evaluations of the same pixel can differ.
CUT_T_WINDOW = 1e-7
CUT_A_WINDOW = 1e-5

# f32 operations per instance-pixel pair: alpha 17 (2 differences, 9 for
# the quadratic, exp, the opacity product, the clamp and 3 for the
# tests), u 1, s 1, inclusion 3, the weight 3, colours 6 (3 products, 3
# tree adds), t_final 2, last_contrib 4; plus the scan: hs 321/64 ~ 5
# products, mxu log, clamp, 2 exp and a difference (5; the kernel does 4:
# its cp_prev is the previous lane's exp2, and an f32 carry add takes the
# difference's place) beside the triangular contraction z @ tri on the
# tensor cores; nocp none. F's
# alpha: 17 and 1 tree add.
OPS_PER_PAIR = {"hs": 42, "mxu": 42, "nocp": 37, "alpha": 18, "outonly": 0, "empty": 0}
# The triangular contraction needs 64 * 65 / 2 multiply-adds per pixel and
# row, 65 flops per pair. The kernel does less on the tensor cores: each
# 8-column block's inclusive sums, one 8x8 triangle per block, twice for
# the split operand (32 flops per pair), then one f32 carry add per pair.
TF32_FLOPS_PER_PAIR = {"mxu": CHUNK + 1}
# f32 fields of each slot a mode reads: x, y, conic a, b, c, opacity, and
# the colour for the scans. `empty` and `outonly` read no record.
FIELDS = {"hs": 9, "mxu": 9, "nocp": 9, "alpha": 6, "outonly": 0, "empty": 0}
# F alpha's exp skip (`csrc/exp_forward.cu`, kFarMargin, kAlphaPix): a
# warp computes no exp for a record whose power lies below
# ln(ALPHA_MIN / opacity) - FAR_MARGIN at all of its ALPHA_WARP_PIXELS
# pixels (32 threads of 2 pixels: 4 rows of the tile).
FAR_MARGIN = 1e-3
ALPHA_WARP_PIXELS = 64


def _check(packed, crs, nch, schedule, field_major_rows: bool, krows: int):
    if krows not in KROWS:
        raise ValueError(f"krows must be one of {KROWS}, got {krows}")
    t = crs.shape[0]
    width = CHUNK if field_major_rows else REC
    if packed.dtype != torch.float32 or packed.dim() != 2 or packed.shape[1] != width:
        raise ValueError(f"packed: expected f32 (rows, {width}), got {packed.dtype} {tuple(packed.shape)}")
    if packed.shape[0] % (REC * CHUNK // width) or packed.shape[0] == 0:
        raise ValueError(f"packed: {packed.shape[0]} is not a whole number of rows")
    for name, x in (("chunk_row_start", crs), ("n_chunks", nch), ("schedule", schedule)):
        if x.dtype != torch.int32 or tuple(x.shape) != (t,):
            raise ValueError(f"{name}: expected int32 ({t},), got {x.dtype} {tuple(x.shape)}")
    for x in (packed, crs, nch, schedule):
        if x.device != packed.device:
            raise ValueError(f"inputs on {x.device} and {packed.device}")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")
    if packed.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {packed.device}")
    return packed.shape[0] * width // (REC * CHUNK)


def _launch(count: LaunchCount, packed, crs, nch, schedule, tiles_x, mode, fm: bool, krows,
            out_cols, out) -> None:
    KERNEL.launch(
        "exp_forward_launch", packed.data_ptr(), crs.data_ptr(), nch.data_ptr(),
        schedule.data_ptr(), crs.shape[0], tiles_x, out.shape[0], MODES[mode], int(fm), krows,
        out_cols, out.data_ptr(), torch.cuda.current_stream(packed.device).cuda_stream,
        count=False,
    )
    count.launches += 1


def blocks_per_sm(mode: str, field_major_rows: bool, krows: int, out_cols: int = SROWS) -> int:
    """The blocks of one instantiation resident on each SM of the current
    card (what its launcher gives each SM). Needs the card."""
    n = KERNEL.lib().exp_forward_blocks_per_sm(MODES[mode], int(field_major_rows), krows, out_cols)
    if n < 0:
        raise RuntimeError(f"exp_forward.cu: occupancy query failed with CUDA error {-n}")
    return n


def walked_rows(rows_out, row_first, row_tile, num_tiles: int):
    """From a per-row state (R, 256, 8) of E (or G's transposed): the rows
    a scan walks, (R,) bool (some pixel of the tile has t_run >= 1e-4 on
    entering the row), and the live pixels on entering each row, (R,
    256). `row_first` (R,) flags each tile's first row, `row_tile` (R,) is
    the row's tile (num_tiles past the used rows)."""
    t_in = torch.roll(rows_out[:, :, 3], 1, dims=0)
    t_in = torch.where(row_first.bool()[:, None], 1.0, t_in)
    live = t_in >= TRANSMITTANCE_EPS
    return live.any(dim=1) & (row_tile < num_tiles), live


def dead_warps(rows_out, row_first, row_tile, num_tiles: int) -> dict:
    """The rows walked (`walked_rows`) and, of their warps (32 pixels),
    those with no live pixel, which in hs form only t_run."""
    walked, live = walked_rows(rows_out, row_first, row_tile, num_tiles)
    dead = ~live.view(live.shape[0], TILE_PIXELS // 32, 32).any(dim=2) & walked[:, None]
    n_walked = int(walked.sum())
    return {"rows_walked": n_walked, "warps_walked": n_walked * (TILE_PIXELS // 32),
            "dead_warps": int(dead.sum())}


def far_records(packed_fm, row_tile, tiles_x: int, num_tiles: int, warp_pixels: int = ALPHA_WARP_PIXELS,
                rows_per_step: int = 512) -> dict:
    """F alpha's exp skip on field-major rows: of the (row, slot, warp)
    triples of the used rows (`row_tile` < num_tiles), `far`, those where
    every pixel of the warp (`warp_pixels` consecutive pixels) has power
    below the slot's far threshold, so that the kernel computes no exp;
    counted with the plain version's power, in steps of `rows_per_step`
    rows."""
    recs = packed_fm.view(-1, REC, CHUNK)
    used = torch.nonzero(row_tile < num_tiles)[:, 0]
    far = 0
    for i in range(0, used.numel(), rows_per_step):
        rr = used[i:i + rows_per_step]
        px, py = _pixels(row_tile[rr].long(), tiles_x)
        rec = recs[rr]
        power = _power(rec, px, py)
        threshold = torch.log(torch.full_like(rec[:, 5], ALPHA_MIN) / rec[:, 5]) - FAR_MARGIN
        is_far = power < threshold[:, None, :]
        far += int(is_far.view(rr.numel(), TILE_PIXELS // warp_pixels, warp_pixels, CHUNK).all(dim=2).sum())
    total = used.numel() * CHUNK * (TILE_PIXELS // warp_pixels)
    return {"far": far, "slot_warps": total, "share": far / max(total, 1)}


def last_rows(crs, nch, max_rows: int) -> torch.Tensor:
    """Each tile's last row, clipped into [0, max_rows) (an empty tile's is
    the row before its start: its neighbour's)."""
    return torch.clamp(crs.long() + nch.long() - 1, 0, max_rows - 1)


# ------------------------------------------------------------------ E


def forward_rows(packed_fm, crs, nch, schedule, tiles_x: int, mode: str = "hs",
                 krows: int = 8) -> torch.Tensor:
    """Kernel E: the per-row state (R, 256, 8) of field-major rows."""
    if mode not in SCANS:
        raise ValueError(f"mode must be one of {SCANS}, got {mode!r}")
    r = _check(packed_fm, crs, nch, schedule, True, krows)
    if packed_fm.device.type == "cpu":
        return forward_rows_plain(packed_fm, crs, nch, schedule, tiles_x, mode)
    out = torch.empty((r, TILE_PIXELS, SROWS), dtype=torch.float32, device=packed_fm.device)
    _launch(E, packed_fm, crs, nch, schedule, tiles_x, mode, True, krows, SROWS, out)
    return out


def exp_forward(packed_fm, crs, nch, schedule, tiles_x: int, mode: str = "hs",
                krows: int = 8) -> torch.Tensor:
    """`exp_fwd.py`'s forward: each tile's state at its last row, (T, 256,
    8). An empty tile carries its neighbour's row, as the script's does."""
    rows_out = forward_rows(packed_fm, crs, nch, schedule, tiles_x, mode, krows)
    return rows_out[last_rows(crs, nch, rows_out.shape[0])]


def forward_rows_plain(packed_fm, crs, nch, schedule, tiles_x: int, mode: str = "hs"):
    """Kernel E's function in PyTorch, vectorised over the tiles and walked
    row by row; `schedule` does not change the result."""
    return scan_plain(packed_fm, crs, nch, tiles_x, mode)[0]


# ------------------------------------------------------------------ G


def transposed_rows(packed, crs, nch, schedule, tiles_x: int, mode: str = "hs",
                    krows: int = 8) -> torch.Tensor:
    """Kernel G: the per-row state (R, 8, 256) of instance-major rows."""
    if mode not in ("hs", "mxu"):
        raise ValueError(f"mode must be hs or mxu, got {mode!r}")
    r = _check(packed, crs, nch, schedule, False, krows)
    if packed.device.type == "cpu":
        return transposed_rows_plain(packed, crs, nch, schedule, tiles_x, mode)
    out = torch.empty((r, SROWS, TILE_PIXELS), dtype=torch.float32, device=packed.device)
    _launch(G, packed, crs, nch, schedule, tiles_x, mode, False, krows, SROWS, out)
    return out


def transposed_rows_plain(packed, crs, nch, schedule, tiles_x: int, mode: str = "hs"):
    return forward_rows_plain(field_major(packed), crs, nch, schedule, tiles_x, mode).transpose(1, 2)


def exp_transposed(packed, crs, nch, schedule, tiles_x: int, mode: str = "hs", krows: int = 8):
    """`exp_transposed.py`'s forward: colors (T, 3, 256), t_final and
    last_contrib (T, 256) at each tile's last row, empty tiles masked."""
    rows_out = transposed_rows(packed, crs, nch, schedule, tiles_x, mode, krows)
    final = rows_out[last_rows(crs, nch, rows_out.shape[0])]
    empty = (nch == 0)[:, None]
    colors = torch.where(empty[:, None, :], 0.0, final[:, 0:3, :])
    t_final = torch.where(empty, 1.0, final[:, 4, :])
    last_contrib = torch.where(empty, 0.0, final[:, 5, :])
    return colors, t_final, last_contrib


# ------------------------------------------------------------------ F


def ablation_rows(packed_fm, crs, nch, schedule, tiles_x: int, mode: str = "alpha",
                  krows: int = 8, out_cols: int = 8) -> torch.Tensor:
    """Kernel F: the per-row state (R, 256, out_cols) of an ablation. For
    `empty` only row 0 is defined (zero)."""
    if mode not in ABLATIONS or out_cols not in (1, 8):
        raise ValueError(f"mode must be one of {ABLATIONS} and out_cols 1 or 8")
    r = _check(packed_fm, crs, nch, schedule, True, krows)
    if packed_fm.device.type == "cpu":
        return ablation_rows_plain(packed_fm, crs, nch, schedule, tiles_x, mode, out_cols)
    out = torch.empty((r, TILE_PIXELS, out_cols), dtype=torch.float32, device=packed_fm.device)
    if mode == "empty":
        out[0].zero_()
    _launch(F, packed_fm, crs, nch, schedule, tiles_x, mode, True, krows, out_cols, out)
    return out


def exp_ablation(packed_fm, crs, nch, schedule, tiles_x: int, mode: str = "alpha",
                 krows: int = 8, out_cols: int = 8) -> torch.Tensor:
    """`exp_fwd2.py`'s forward: row 0 of the per-row state, (256, out_cols)."""
    return ablation_rows(packed_fm, crs, nch, schedule, tiles_x, mode, krows, out_cols)[0]


def ablation_rows_plain(packed_fm, crs, nch, schedule, tiles_x: int, mode: str = "alpha",
                        out_cols: int = 8) -> torch.Tensor:
    r = packed_fm.shape[0] // REC
    out = torch.zeros((r, TILE_PIXELS, out_cols), dtype=torch.float32, device=packed_fm.device)
    if mode != "alpha":
        return out
    recs = packed_fm.view(r, REC, CHUNK)
    tiles, counts = _tiles_longest_first(nch)
    px, py = _pixels(tiles, tiles_x)
    acc = torch.zeros((tiles.shape[0], TILE_PIXELS), dtype=torch.float32, device=packed_fm.device)
    for j, live in _steps(counts):
        rr = crs[tiles[:live]].long() + j
        a, _ = _alpha(recs[rr], px[:live], py[:live])
        acc[:live] = acc[:live] + _tree_sum(a)
        out[rr, :, 0] = acc[:live]
    return out


# ------------------------------------------------------------------ plain


def _tiles_longest_first(nch):
    tiles = torch.nonzero(nch > 0)[:, 0]
    tiles = tiles[torch.argsort(nch[tiles], descending=True, stable=True)]
    return tiles, nch[tiles].tolist()


def _steps(counts):
    """(j, number of tiles with more than j rows) for the rows of the
    longest tile; the tiles come longest first, so those are a prefix."""
    live = len(counts)
    for j in range(counts[0] if counts else 0):
        while counts[live - 1] <= j:
            live -= 1
        yield j, live


def _pixels(tiles, tiles_x: int):
    p = torch.arange(TILE_PIXELS, device=tiles.device)
    lx = (p % TILE).to(torch.float32)
    ly = (p // TILE).to(torch.float32)
    px = ((tiles % tiles_x) * TILE).to(torch.float32)[:, None] + lx[None, :]
    py = ((tiles // tiles_x) * TILE).to(torch.float32)[:, None] + ly[None, :]
    return px, py


def _alpha(rec, px, py):
    """rec (L, REC, CHUNK) field-major rows, px/py (L, 256): alpha (L, 256,
    CHUNK) with the cut-offs applied, and the clamped alpha before them."""
    power = _power(rec, px, py)
    alpha = torch.clamp_max(rec[:, 5, None, :] * torch.exp(power), ALPHA_MAX)
    a = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, 0.0)
    return a, torch.where(power <= 0.0, alpha, float("inf"))


def _power(rec, px, py):
    """The Gaussian's exponent at each pixel and slot, (L, 256, CHUNK)."""
    mx, my = rec[:, 0, None, :], rec[:, 1, None, :]
    ca, cb, cc = rec[:, 2, None, :], rec[:, 3, None, :], rec[:, 4, None, :]
    dx = mx - px[:, :, None]
    dy = my - py[:, :, None]
    return -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy


def _tree_sum(v):
    """Sum over the last axis (64) by halving: v[i] + v[i + h], h = 32..1."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def scan_plain(packed_fm, crs, nch, tiles_x: int, mode: str, margins: bool = False):
    """Kernel E's function. Returns (rows_out (R, 256, 8), info): info
    holds `walked` (R,) bool, the rows not skipped, and with `margins`,
    per tile pixel (T, 256), `t_margin`, the least |s - 1e-4| over the
    pairs with alpha > 0 in the rows walked, and `a_margin`, the least
    |alpha / (1/255) - 1| over the pairs with power <= 0 (inf where
    none)."""
    dev = packed_fm.device
    r = packed_fm.shape[0] // REC
    recs = packed_fm.view(r, REC, CHUNK)
    init = torch.tensor(INITIAL, dtype=torch.float32, device=dev)
    out = init.expand(r, TILE_PIXELS, SROWS).clone()
    tiles, counts = _tiles_longest_first(nch)
    px, py = _pixels(tiles, tiles_x)
    state = init.expand(tiles.shape[0], TILE_PIXELS, SROWS).clone()
    lane = torch.arange(CHUNK, dtype=torch.float32, device=dev)
    walked = torch.zeros(r, dtype=torch.bool, device=dev)
    t = nch.shape[0]
    t_margin = torch.full((t, TILE_PIXELS), float("inf"), device=dev)
    a_margin = torch.full((t, TILE_PIXELS), float("inf"), device=dev)
    if mode == "mxu":
        idx = torch.arange(CHUNK, device=dev)
        tri = (idx[:, None] <= idx[None, :]).to(torch.float32)
    for j, live in _steps(counts):
        rr = crs[tiles[:live]].long() + j
        go = torch.nonzero((state[:live, :, 3] >= TRANSMITTANCE_EPS).any(dim=1))[:, 0]
        if go.numel():
            g_rows = rr[go]
            walked[g_rows] = True
            rec = recs[g_rows]
            a, alpha_raw = _alpha(rec, px[go], py[go])
            u = 1.0 - a
            if mode == "hs":
                cp = u
                kk = 1
                while kk < CHUNK:
                    cp = cp * torch.cat([torch.ones_like(cp[..., :kk]), cp[..., :-kk]], dim=-1)
                    kk *= 2
                cp_prev = torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)
            elif mode == "mxu":
                z = torch.log(torch.clamp_min(u, 1e-30))
                zc = torch.matmul(z, tri)
                cp = torch.exp(zc)
                cp_prev = torch.exp(zc - z)
            else:
                cp = cp_prev = u
            st = state[go]
            t_row = st[:, :, 3:4]
            s = t_row * cp
            include = (s >= TRANSMITTANCE_EPS) & (a > 0.0)
            w = torch.where(include, t_row * cp_prev * a, 0.0)
            color = torch.stack([_tree_sum(w * rec[:, None, 6 + c, :]) for c in range(3)], dim=-1)
            tf = torch.where(include, s, 1.0).amin(dim=-1)
            pos = (g_rows * CHUNK).to(torch.float32)[:, None, None] + lane + 1.0
            lc = torch.where(include, pos, 0.0).amax(dim=-1)
            new = st.clone()
            new[:, :, 0:3] = st[:, :, 0:3] + color
            new[:, :, 4] = torch.minimum(st[:, :, 4], tf)
            new[:, :, 5] = torch.maximum(st[:, :, 5], lc)
            new[:, :, 3] = s[:, :, CHUNK - 1]
            state[go] = new
            if margins:
                tg = tiles[go]
                dt = torch.where(a > 0.0, (s - TRANSMITTANCE_EPS).abs(), float("inf")).amin(dim=-1)
                da = (alpha_raw / ALPHA_MIN - 1.0).abs().amin(dim=-1)
                t_margin[tg] = torch.minimum(t_margin[tg], dt)
                a_margin[tg] = torch.minimum(a_margin[tg], da)
        out[rr] = state[:live]
    return out, {"walked": walked, "t_margin": t_margin, "a_margin": a_margin}


def near_cut(packed_fm, crs, nch, tiles_x: int) -> torch.Tensor:
    """(T, 256) bool: pixels whose result may flip with the last bits of
    the arithmetic, because some running product lies within CUT_T_WINDOW
    of the 1e-4 cut, or some alpha within CUT_A_WINDOW (relative) of
    1/255."""
    _, info = scan_plain(packed_fm, crs, nch, tiles_x, "hs", margins=True)
    return (info["t_margin"] <= CUT_T_WINDOW) | (info["a_margin"] <= CUT_A_WINDOW)


def pairs(windows, n_gaussians: int, walked=None) -> int:
    """Instance-pixel pairs a kernel evaluates: 256 for each live (not
    padding, id < n_gaussians) lane of `windows` ((R, 64) ids from
    `rows.pack_rows`), over the rows `walked` ((R,) bool) or all rows."""
    live = (windows < n_gaussians).sum(dim=1)
    if walked is not None:
        live = live[walked]
    return int(live.sum()) * TILE_PIXELS


def _near_rows(got, row_tile, near) -> torch.Tensor:
    """(R, 256) bool: `near` (T, 256) spread over the rows of each tile;
    rows past the last tile's (row_tile == T) have no pixel near a cut."""
    t = near.shape[0]
    live = row_tile < t
    out = torch.zeros(got.shape[:2], dtype=torch.bool, device=got.device)
    out[live] = near[row_tile[live].long()]
    return out


def rows_error(got, want, row_tile, near) -> dict:
    """Two per-row states (R, 256, 8) against each other, off the pixels
    `near` (T, 256) a cut, where an inclusion may flip: the max |err| of
    columns 0-4 (colours, t_run, t_final) and the number of last_contrib
    values that differ. Rows past the last tile's (row_tile == T) have no
    pixel near a cut."""
    d = (got - want).abs()[~_near_rows(got, row_tile, near)]
    return {"values": float(d[:, :5].max()) if d.numel() else 0.0,
            "last_contrib_flips": int((d[:, 5] > 0).sum()),
            "finite": bool(torch.isfinite(got).all())}


def error_site(got, want, row_tile, chunk_row_start, near) -> dict:
    """Where two per-row states (R, 256, 8) differ most in columns 0-4 off
    the pixels `near` (T, 256) a cut, as `rows_error` measures them: the
    row, its tile, the pixel and column, both values; whether that pixel
    is near a cut and how many pixels of its tile are; and the rows of its
    tile, up to this one, whose skip vote (some pixel has t_run >= 1e-4
    on entering the row) differs between `got` and `want`."""
    t = near.shape[0]
    d = (got - want).abs()[:, :, :5].masked_fill(_near_rows(got, row_tile, near)[:, :, None], 0.0)
    row, pixel, col = (int(i) for i in torch.unravel_index(torch.argmax(d), d.shape))
    site = {"row": row, "pixel": pixel, "column": col, "err": float(d[row, pixel, col]),
            "got": float(got[row, pixel, col]), "want": float(want[row, pixel, col]), "tile": None}
    tile = int(row_tile[row])
    if tile < t:
        first = int(chunk_row_start[tile])

        def votes(x):
            return [True] + [bool((x[r - 1, :, 3] >= TRANSMITTANCE_EPS).any()) for r in range(first + 1, row + 1)]

        site.update(tile=tile, near_cut=bool(near[tile, pixel]), tile_near_cut_pixels=int(near[tile].sum()),
                    vote_differs_rows=[r for r, a, b in zip(range(first, row + 1), votes(got), votes(want))
                                       if a != b])
    return site
