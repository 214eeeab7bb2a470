"""The gather experiments: Kernels H, I, J and K, their wrappers, plain
PyTorch versions and launch counts.

They replace the Pallas kernels of three experiment scripts that decided
how the TPU rasterizer's packed rows are gathered (`PERF_NOTES.md`):
- H, `scripts/exp_vmem_gather.py::kern` (`pallas_call` at :46): per grid
  step, the sum over its 8 rows of (128, 16) records gathered by id from a
  table held in VMEM;
- I, `scripts/exp_dma_gather.py::kern_a` (:62): per grid step, the sum
  over its 8 rows of rec + rec, read from the pre-packed (padded) gather;
- J, `scripts/exp_dma_gather.py::kern_b` (:117): the sum over every row
  of rec + rec, each row's window `attr[start : start + 128]` DMA'd in the
  kernel;
- K, `scripts/exp_gather_layout.py::ident` (:39): the identity copy, in
  blocks of 8,192 rows, that gives a gather a row-major source.

Each computes what its Pallas program computes, quirks included. H's and
J's programs never compiled on the TPU (Mosaic has no dynamic vector
gather, and the window DMA at unaligned sublane offsets does not lower),
so their meaning is the Pallas semantics that interpret mode runs:
- H and I map every grid step's output to the same block and assign to
  it, so the scripts get only the last step's sum. The kernels still do
  every step's gather: they return every step's partial, (steps, 128,
  16), and `vmem_gather` and `packed_sum` the last;
- each grid has ROWS // KROWS steps; rows past the last whole step are
  read by none of H, I and J;
- J sums in blocks of J_ROWS_PER_BLOCK rows, each in row order from zero,
  then adds the block partials in block order; the TPU's serial sum over
  the rows differs from it in the last bits;
- the scripts' ids and starts lie in range. Out of range, ids are clamped
  into the table (JAX's rule for a gather) and starts into the last
  window of `attr` (no window leaves the array), in kernel and plain
  version alike.

On a CUDA tensor each wrapper launches its kernel (`csrc/gather.cu`); on a
CPU tensor it runs the plain version. There is no fallback. All four equal
their plain versions bit for bit (the same f32 adds in the same order).
"""

from __future__ import annotations

import torch

from sgs_tpu_torch.ops.build import INT, PTR, CudaKernel, LaunchCount

# The scripts' constants. CHUNK is 128 lanes here (the forward-raster rows
# of `ops/rows.py` hold 64).
CHUNK = 128
KROWS = 8
REC = 16
N = 100_000  # exp_vmem_gather.py: table rows
ROWS = 16128  # exp_vmem_gather.py, exp_dma_gather.py: rows of 128 lanes
M = 1_019_904  # exp_dma_gather.py: attribute rows (+ CHUNK rows of tail pad)
OUT_ROWS = 1_019_904  # exp_gather_layout.py: ids gathered
SRC = 2_064_384  # exp_gather_layout.py: table rows
WIDTHS = (16, 8)  # exp_gather_layout.py: table widths, in the script's order
# J's rows per block; csrc/gather.cu's kRowsPerBlock must match.
J_ROWS_PER_BLOCK = 128

KERNEL = CudaKernel(
    "gather.cu",
    {"gather_vmem_launch": [PTR, INT, PTR, INT, PTR, PTR],
     "gather_packed_launch": [PTR, INT, PTR, PTR],
     "gather_dma_launch": [PTR, INT, PTR, INT, PTR, PTR, PTR, PTR],
     "gather_identity_launch": [PTR, INT, INT, INT, PTR, PTR]},
    extra_flags=("--fmad=false",),
)
H, I, J, K = LaunchCount("H"), LaunchCount("I"), LaunchCount("J"), LaunchCount("K")


def _check(name: str, x: torch.Tensor, dtype, shape) -> None:
    """`shape`: the sizes `x` must have, None for any."""
    if x.dtype != dtype or x.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, x.shape)):
        raise ValueError(f"{name}: expected {dtype} of shape {shape}, got {x.dtype} {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name}: the kernels read 16-byte aligned tensors")


def _same_device(*xs) -> None:
    if any(x.device != xs[0].device for x in xs):
        raise ValueError(f"inputs on {[str(x.device) for x in xs]}")


def _contiguous(name: str, x: torch.Tensor) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def grid_steps(n_rows: int) -> int:
    """The scripts' grid: ROWS // KROWS steps of KROWS rows."""
    steps = n_rows // KROWS
    if steps == 0:
        raise ValueError(f"{n_rows} rows make no grid step of {KROWS}")
    return steps


# ------------------------------------------------------------------ H


def vmem_gather_steps(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Kernel H: for each grid step k of `exp_vmem_gather.py`, the sum over
    j < 8 of `table[ids[k*1024 + j*128 : +128]]`, (steps, 128, 16)."""
    _check("table", table, torch.float32, (None, REC))
    _check("ids", ids, torch.int32, (None,))
    _same_device(table, ids)
    _contiguous("table", table)
    _contiguous("ids", ids)
    steps = grid_steps(ids.numel() // CHUNK)
    if table.device.type == "cpu":
        return vmem_gather_steps_plain(table, ids)
    out = torch.empty((steps, CHUNK, REC), dtype=torch.float32, device=table.device)
    KERNEL.launch("gather_vmem_launch", table.data_ptr(), table.shape[0], ids.data_ptr(), steps,
                  out.data_ptr(), _stream(table), count=False)
    H.launches += 1
    return out


def vmem_gather_steps_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    steps = grid_steps(ids.numel() // CHUNK)
    idx = ids[: steps * KROWS * CHUNK].long().clamp(0, table.shape[0] - 1).view(steps, KROWS, CHUNK)
    acc = torch.zeros((steps, CHUNK, REC), dtype=torch.float32, device=table.device)
    for j in range(KROWS):
        acc = acc + table[idx[:, j]]
    return acc


def vmem_gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """`exp_vmem_gather.py`'s Pallas output: the last step's sum, (128, 16)."""
    return vmem_gather_steps(table, ids)[-1]


# ------------------------------------------------------------------ I


def packed_sum_steps(packed: torch.Tensor) -> torch.Tensor:
    """Kernel I: for each grid step k of `exp_dma_gather.py`'s variant A,
    the sum over j < 8 of rec + rec, rec = packed rows (k*8 + j)*128 ..
    +128, (steps, 128, 16)."""
    _check("packed", packed, torch.float32, (None, REC))
    _contiguous("packed", packed)
    steps = grid_steps(packed.shape[0] // CHUNK)
    if packed.device.type == "cpu":
        return packed_sum_steps_plain(packed)
    out = torch.empty((steps, CHUNK, REC), dtype=torch.float32, device=packed.device)
    KERNEL.launch("gather_packed_launch", packed.data_ptr(), steps, out.data_ptr(), _stream(packed),
                  count=False)
    I.launches += 1
    return out


def packed_sum_steps_plain(packed: torch.Tensor) -> torch.Tensor:
    steps = grid_steps(packed.shape[0] // CHUNK)
    rec = packed[: steps * KROWS * CHUNK].view(steps, KROWS, CHUNK, REC)
    acc = torch.zeros((steps, CHUNK, REC), dtype=torch.float32, device=packed.device)
    for j in range(KROWS):
        acc = acc + (rec[:, j] + rec[:, j])
    return acc


def packed_sum(packed: torch.Tensor) -> torch.Tensor:
    """`exp_dma_gather.py`'s variant A output: the last step's sum."""
    return packed_sum_steps(packed)[-1]


# ------------------------------------------------------------------ J


def dma_gather(attr: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Kernel J: `exp_dma_gather.py`'s variant B, the sum over the rows r
    of its grid of w + w, w = attr[starts[r] : starts[r] + 128], (128, 16).
    No clamp at M: a window may start at M and read the tail pad."""
    _check("attr", attr, torch.float32, (None, REC))
    _check("starts", starts, torch.int32, (None,))
    _same_device(attr, starts)
    _contiguous("attr", attr)
    _contiguous("starts", starts)
    if attr.shape[0] < CHUNK:
        raise ValueError(f"attr: {attr.shape[0]} rows hold no window of {CHUNK}")
    rows = grid_steps(starts.numel()) * KROWS
    if attr.device.type == "cpu":
        return dma_gather_plain(attr, starts)
    blocks = -(-rows // J_ROWS_PER_BLOCK)
    partials = torch.empty((blocks, CHUNK, REC), dtype=torch.float32, device=attr.device)
    out = torch.empty((CHUNK, REC), dtype=torch.float32, device=attr.device)
    KERNEL.launch("gather_dma_launch", attr.data_ptr(), attr.shape[0], starts.data_ptr(), rows,
                  partials.data_ptr(), KERNEL.ticket(attr.device).data_ptr(), out.data_ptr(),
                  _stream(attr), count=False)
    J.launches += 1
    return out


def dma_gather_plain(attr: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Kernel J's sum order: blocks of J_ROWS_PER_BLOCK rows, each summed
    in row order from zero (all blocks at once, row i of every block in
    turn), then the block partials added in block order."""
    dev = attr.device
    rows = grid_steps(starts.numel()) * KROWS
    s = starts[:rows].long().clamp(0, attr.shape[0] - CHUNK)
    lanes = torch.arange(CHUNK, device=dev)
    blocks = -(-rows // J_ROWS_PER_BLOCK)
    first = torch.arange(blocks, device=dev) * J_ROWS_PER_BLOCK
    part = torch.zeros((blocks, CHUNK, REC), dtype=torch.float32, device=dev)
    for i in range(J_ROWS_PER_BLOCK):
        live = -(-(rows - i) // J_ROWS_PER_BLOCK)  # blocks with a row i: a prefix
        if live <= 0:
            break
        w = attr[s[first[:live] + i][:, None] + lanes]
        part[:live] = part[:live] + (w + w)
    total = torch.zeros((CHUNK, REC), dtype=torch.float32, device=dev)
    for b in range(blocks):
        total = total + part[b]
    return total


# ------------------------------------------------------------------ K


def layout(x: torch.Tensor) -> str:
    """"row-major" for a contiguous (rows, rec) table, "field-major" for
    one with strides (1, rows), the counterpart of XLA's compact {0,1}."""
    if x.is_contiguous():
        return "row-major"
    if x.stride() == (1, x.shape[0]):
        return "field-major"
    raise ValueError(f"strides {x.stride()} are neither row-major nor field-major")


def field_major(x: torch.Tensor) -> torch.Tensor:
    """The values of a (rows, rec) table held field-major."""
    return x.t().contiguous().t()


def layout_identity(x: torch.Tensor) -> torch.Tensor:
    """Kernel K: `exp_gather_layout.py`'s identity, out = x, written
    row-major from a row-major or field-major (rows, 16 or 8) f32 table."""
    _check("x", x, torch.float32, (None, None))
    if x.shape[1] not in WIDTHS or x.shape[0] == 0:
        raise ValueError(f"x: expected (rows, {WIDTHS}), got {tuple(x.shape)}")
    fm = layout(x) == "field-major"
    if x.device.type == "cpu":
        return layout_identity_plain(x)
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    KERNEL.launch("gather_identity_launch", x.data_ptr(), x.shape[0], x.shape[1], int(fm),
                  out.data_ptr(), _stream(x), count=False)
    K.launches += 1
    return out


def layout_identity_plain(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device).copy_(x)
