"""What each design choice of Kernels D and B buys, on the card.

    python -m sgs_tpu_torch.tools.ssim_ablation

Builds variants of `csrc/ssim_backward.cu` (D), `csrc/ssim.cu` (B) and
their shared `csrc/ssim_common.cuh`, each with one choice of the committed
design undone by a text substitution, into
`build/sgs_tpu_torch/ablation/<variant>/`, and times each variant (CUDA
events) on the inputs of one flagship training step (test view 0 of
data/flagship800: the rendered image and the ground truth), alternating
the committed kernel with the variant. Every variant must give the
committed kernel's bits, except B with another tile, whose sum order
differs: it must equal `ssim_plain` summed in its own order. The
committed D is also timed with and without dy. Prints one JSON line per
variant and the card's name and power limit. The variants exist only
here: the package builds the committed sources alone.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
from pathlib import Path

import torch

from sgs_tpu_torch.ops import build, flat_raster, ssim as ssim_ops
from sgs_tpu_torch.ops.build import FLOAT, INT, PTR
from sgs_tpu_torch.tools.ssim_times import step_images, time_ms

HEADER = "ssim_common.cuh"
SOURCES = {"D": "ssim_backward.cu", "B": "ssim.cu"}

# The window passes read every tap from shared memory (as PR 5's kernels
# did): no register sliding, and so each product formed once per tap.
PER_TAP = '''template <int S>
__device__ __forceinline__ void slide_stats(const float* px, const float* py, int step,
                                            const Window& win, float (&acc)[5][S])
{
  const volatile float* vpx = px;
  const volatile float* vpy = py;
#pragma unroll
  for (int o = 0; o < S; ++o) {
#pragma unroll
    for (int m = 0; m < 5; ++m) acc[m][o] = 0.0f;
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const float vx = vpx[(o + k) * step], vy = vpy[(o + k) * step];
      const float v[5] = {vx, vy, vx * vx, vy * vy, vx * vy};
#pragma unroll
      for (int m = 0; m < 5; ++m) acc[m][o] += win.w[k] * v[m];
    }
  }
}

template <int M, int S>
__device__ __forceinline__ void slide(const float* src, int map_stride, int step,
                                      const Window& win, float (&acc)[M][S])
{
  const volatile float* vsrc = src;
#pragma unroll
  for (int o = 0; o < S; ++o) {
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m][o] = 0.0f;
#pragma unroll
    for (int k = 0; k < kWin; ++k)
#pragma unroll
      for (int m = 0; m < M; ++m) acc[m][o] += win.w[k] * vsrc[m * map_stride + (o + k) * step];
  }
}

}  // namespace ssim
'''

# D as two launches with four maps in device memory (gmap, (4, 3, H, W):
# ga, gc, ge, gb), 32x32 aligned tiles and the sliding passes in both.
TWO_LAUNCH_D = '''
namespace {

constexpr int kT = 32, kTL = 8, kTRows = kT + 2 * kPad;
constexpr int kTCols = round_up(kTL + kT + kPad, 4), kTPitch = odd(kTCols + 1), kTH = odd(kT);
constexpr int kTIn = kTRows * kTPitch, kTMid = kTRows * kTH;

__global__ void __launch_bounds__(256)
gmap_kernel(const float* __restrict__ x, const float* __restrict__ y, int height, int width,
            Window win, float* __restrict__ gmap)
{
  __shared__ float sx[kTIn], sy[kTIn], sh[5 * kTMid];
  const int c = blockIdx.z, ty0 = blockIdx.y * kT, tx0 = blockIdx.x * kT;
  const size_t plane = (size_t)height * width;
  load_pair(x + c * plane, y + c * plane, height, width, ty0 - kPad, tx0 - kTL, kTRows, kTCols,
            kTPitch, sx, sy);
  __syncthreads();
  for (int i = threadIdx.x; i < kTRows * 4; i += 256) {
    const int r = i % kTRows, q0 = (i / kTRows) * 8, off = r * kTPitch + kTL - kPad + q0;
    float acc[5][8];
    slide_stats<8>(sx + off, sy + off, 1, win, acc);
#pragma unroll
    for (int m = 0; m < 5; ++m)
#pragma unroll
      for (int o = 0; o < 8; ++o) sh[m * kTMid + r * kTH + q0 + o] = acc[m][o];
  }
  __syncthreads();
  const int q = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 4, gx = tx0 + q;
  float acc[5][4];
  slide<5, 4>(sh + r0 * kTH + q, kTMid, kTH, win, acc);
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int gy = ty0 + r0 + o;
    if (gy >= height || gx >= width) continue;
    const float a = acc[0][o], b = acc[1][o], cc = acc[2][o], d = acc[3][o], e = acc[4][o];
    const float n1 = 2.0f * a * b + kC1;
    const float n2 = 2.0f * (e - a * b) + kC2;
    const float d1 = a * a + b * b + kC1;
    const float d2 = (cc - a * a) + (d - b * b) + kC2;
    const float inv = 1.0f / (d1 * d2);
    const float mp = n1 * n2 * inv;
    float* out = gmap + c * plane + (size_t)gy * width + gx;
    out[0] = 2.0f * b * (n2 - n1) * inv - mp * (2.0f * a / d1 - 2.0f * a / d2);
    out[3 * plane] = -mp / d2;
    out[6 * plane] = 2.0f * n1 * inv;
    out[9 * plane] = 2.0f * a * (n2 - n1) * inv - mp * (2.0f * b / d1 - 2.0f * b / d2);
  }
}

__global__ void __launch_bounds__(256)
combine_kernel(const float* __restrict__ gmap, const float* __restrict__ x,
               const float* __restrict__ y, const float* __restrict__ cot, float count,
               int height, int width, Window win, float* __restrict__ dx, float* __restrict__ dy)
{
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = smem + 4 * kTIn;
  const int c = blockIdx.z, ty0 = blockIdx.y * kT, tx0 = blockIdx.x * kT;
  const size_t plane = (size_t)height * width;
  for (int m = 0; m < 4; m += 2)
    load_pair(gmap + (3 * m + c) * plane, gmap + (3 * m + 3 + c) * plane, height, width,
              ty0 - kPad, tx0 - kTL, kTRows, kTCols, kTPitch, sg + m * kTIn, sg + (m + 1) * kTIn);
  __syncthreads();
  for (int i = threadIdx.x; i < kTRows * 4; i += 256) {
    const int r = i % kTRows, q0 = (i / kTRows) * 8;
    float acc[4][8];
    slide<4, 8>(sg + r * kTPitch + kTL - kPad + q0, kTIn, 1, win, acc);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int o = 0; o < 8; ++o) sh[m * kTMid + r * kTH + q0 + o] = acc[m][o];
  }
  __syncthreads();
  const int q = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 4, gx = tx0 + q;
  float acc[4][4];
  slide<4, 4>(sh + r0 * kTH + q, kTMid, kTH, win, acc);
  const float scale = cot[0] / count;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int gy = ty0 + r0 + o;
    if (gy >= height || gx >= width) continue;
    const size_t off = c * plane + (size_t)gy * width + gx;
    const float vx = x[off], vy = y[off];
    dx[off] = (acc[0][o] + 2.0f * vx * acc[1][o] + vy * acc[2][o]) * scale;
    dy[off] = (acc[3][o] + 2.0f * vy * acc[1][o] + vx * acc[2][o]) * scale;
  }
}

}  // namespace

extern "C" int ssim_backward_two(void* x, void* y, void* cot, float count, int height, int width,
                                 const float* window, void* gmap, void* dx, void* dy, void* stream)
{
  Window win;
  for (int k = 0; k < kWin; ++k) win.w[k] = window[k];
  const int smem = (int)sizeof(float) * (4 * kTIn + 4 * kTMid);
  cudaError_t err = cudaFuncSetAttribute(combine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((width + kT - 1) / kT, (height + kT - 1) / kT, 3);
  gmap_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>((const float*)x, (const float*)y, height,
                                                     width, win, (float*)gmap);
  combine_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      (const float*)gmap, (const float*)x, (const float*)y, (const float*)cot, count, height, width,
      win, (float*)dx, (float*)dy);
  return (int)cudaGetLastError();
}
'''

TICKET = '''  const int blocks = gridDim.x * gridDim.y * gridDim.z;
  if (threadIdx.x == 0) {
    partials[(c * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == (unsigned)(blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  final_sum(partials, blocks, count, red, out);
  if (threadIdx.x == 0) *ticket = 0u;
}
'''
# B's cross-block sum as a second launch of one block, in the same order.
TWO_LAUNCH_B = '''  if (threadIdx.x == 0) partials[(c * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
final_kernel(const float* __restrict__ partials, int n, float count, float* __restrict__ out)
{
  __shared__ float red[kWarps];
  final_sum(partials, n, count, red, out);
}
'''
FINAL_LAUNCHER = '''
extern "C" int ssim_final(void* partials, int n, float count, void* out, void* stream)
{
  final_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>((const float*)partials, n, count,
                                                         (float*)out);
  return (int)cudaGetLastError();
}
'''

# name -> (kernel, what it changes, {file: [(committed text, variant text)]},
# and for B with another tile, the constants of `ops/ssim.py` that give
# its partial count and its sum order)
VARIANTS = {
    "D_tile32": ("D", "32x32 output tiles with 256 threads (strips 7, 7, 8, 4) in place of 48x32 "
                      "with 512 (strips 6, 5, 8, 4)",
                 {SOURCES["D"]: [("constexpr int kTileH = 48;", "constexpr int kTileH = 32;"),
                                 ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;"),
                                 ("constexpr int kStripW1 = 6;", "constexpr int kStripW1 = 7;"),
                                 ("constexpr int kStripH1 = 5;", "constexpr int kStripH1 = 7;")]}),
    "D_tile16": ("D", "16x16 output tiles (PR 5's size) with 256 threads",
                 {SOURCES["D"]: [("constexpr int kTileH = 48;", "constexpr int kTileH = 16;"),
                                 ("constexpr int kTileW = 32;", "constexpr int kTileW = 16;"),
                                 ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")]}),
    "D_per_tap": ("D", "every tap read from shared memory, each product formed per tap "
                       "(no register sliding)", {HEADER: [("SLIDE", PER_TAP)]}),
    "D_two_launch": ("D", "two launches with four (3, H, W) maps in device memory, 32x32 aligned "
                          "tiles, sliding passes", {SOURCES["D"]: [("APPEND", TWO_LAUNCH_D)]}),
    "B_tile32": ("B", "32x32 output tiles with 256 threads (W strips of 8) in place of 48x32 "
                      "with 384 (W strips of 4)",
                 {SOURCES["B"]: [("constexpr int kTileH = 48;", "constexpr int kTileH = 32;"),
                                 ("constexpr int kThreads = 384;", "constexpr int kThreads = 256;"),
                                 ("constexpr int kStripW = 4;", "constexpr int kStripW = 8;")]},
                 {"TILE_H": 32, "THREADS": 256, "WARPS": 8}),
    "B_per_tap": ("B", "every tap read from shared memory, each product formed per tap "
                       "(no register sliding)", {HEADER: [("SLIDE", PER_TAP)]}),
    "B_two_launch": ("B", "the cross-block sum as a second launch of one block (no ticket)",
                     {SOURCES["B"]: [(TICKET, TWO_LAUNCH_B), ("APPEND", FINAL_LAUNCHER)]}),
}


@contextlib.contextmanager
def constants(name: str):
    """`ops/ssim.py`'s tile constants set for variant `name` while it runs."""
    new = VARIANTS[name][3] if len(VARIANTS[name]) > 3 else {}
    saved = {k: getattr(ssim_ops, k) for k in new}
    for k, v in new.items():
        setattr(ssim_ops, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(ssim_ops, k, v)


def variant_source(name: str) -> Path:
    """Write variant `name`'s copy of the sources; returns its kernel source."""
    kernel, edits = VARIANTS[name][0], VARIANTS[name][2]
    out = build.BUILD_DIR / "ablation" / name
    out.mkdir(parents=True, exist_ok=True)
    for fname in (HEADER, *SOURCES.values()):
        text = (build.CSRC_DIR / fname).read_text()
        for old, new in edits.get(fname, []):
            if old == "APPEND":
                text += new
                continue
            if old == "SLIDE":
                old = text[text.index("// The first pass of the statistics"):]
            if old not in text:
                raise RuntimeError(f"variant {name}: committed text not found in {fname}: {old[:80]!r}")
            text = text.replace(old, new)
        (out / fname).write_text(text)
    return out / SOURCES[kernel]


def variant_kernel(name: str) -> build.CudaKernel:
    kernel = VARIANTS[name][0]
    committed = ssim_ops.BACKWARD if kernel == "D" else ssim_ops.KERNEL
    functions = dict(committed.functions)
    if name == "D_two_launch":
        functions["ssim_backward_two"] = [PTR, PTR, PTR, FLOAT, INT, INT,
                                          functions["ssim_backward"][6], PTR, PTR, PTR, PTR]
    if name == "B_two_launch":
        functions["ssim_final"] = [PTR, INT, FLOAT, PTR, PTR]
    return build.CudaKernel(str(variant_source(name)), functions, extra_flags=("--fmad=false",))


def calls(name: str, kernel: build.CudaKernel, x, y, cot):
    """The committed call and the variant's, each returning its result."""
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _, h, w = x.shape
    if VARIANTS[name][0] == "D":
        committed = lambda: ssim_ops.ssim_backward(x, y, cot)
        if name == "D_two_launch":
            gmap = torch.empty((4, 3, h, w), device=x.device)

            def variant():
                dx, dy = torch.empty_like(x), torch.empty_like(y)
                kernel.launch("ssim_backward_two", x.data_ptr(), y.data_ptr(), cot.data_ptr(),
                              float(3 * h * w), h, w, ssim_ops._window_arg(), gmap.data_ptr(),
                              dx.data_ptr(), dy.data_ptr(), stream)
                return dx, dy
        else:
            def variant():
                saved, ssim_ops.BACKWARD = ssim_ops.BACKWARD, kernel
                try:
                    return ssim_ops.ssim_backward(x, y, cot)
                finally:
                    ssim_ops.BACKWARD = saved
        return committed, variant
    committed = lambda: ssim_ops.ssim_forward(x, y)
    if name == "B_two_launch":
        ticket = torch.zeros((), dtype=torch.int32, device=x.device)

        def variant():
            n = 3 * (-(-h // ssim_ops.TILE_H)) * (-(-w // ssim_ops.TILE_W))
            partials = torch.empty(n, device=x.device)
            out = torch.empty((), device=x.device)
            kernel.launch("ssim_forward", x.data_ptr(), y.data_ptr(), h, w, ssim_ops._window_arg(),
                          float(3 * h * w), partials.data_ptr(), ticket.data_ptr(), out.data_ptr(),
                          stream)
            kernel.launch("ssim_final", partials.data_ptr(), n, float(3 * h * w), out.data_ptr(),
                          stream)
            return out
        return committed, variant

    def variant():
        saved, ssim_ops.KERNEL = ssim_ops.KERNEL, kernel
        try:
            with constants(name):
                return ssim_ops.ssim_forward(x, y)
        finally:
            ssim_ops.KERNEL = saved
    return committed, variant


def same_bits(name: str, got, want, x, y) -> bool:
    """The variant's result against the committed kernel's; B with another
    tile against `ssim_plain` summed in that tile's order."""
    if len(VARIANTS[name]) > 3:
        with constants(name):
            want = ssim_ops.ssim_plain(x, y)
    if isinstance(got, tuple):
        return all(torch.equal(g, w) for g, w in zip(got, want))
    return torch.equal(got, want)


def alternate(committed, variant) -> dict:
    """committed, variant, variant, committed."""
    times = {"committed_ms": [], "variant_ms": []}
    for first in (True, False):
        for is_committed in (first, not first):
            fn = committed if is_committed else variant
            times["committed_ms" if is_committed else "variant_ms"].append(time_ms(fn))
    return times


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ssim_ablation: needs a CUDA device")
    dev = torch.device("cuda")
    kernels = {name: variant_kernel(name) for name in VARIANTS}
    build.build_all([flat_raster.KERNEL, ssim_ops.KERNEL, ssim_ops.BACKWARD, *kernels.values()])
    x, y = step_images(dev)
    cot = torch.tensor(-0.2, device=dev)
    for name, kernel in kernels.items():
        committed, variant = calls(name, kernel, x, y, cot)
        times = alternate(committed, variant)
        ok = same_bits(name, variant(), committed(), x, y)
        regs = [ln.split(":")[-1].strip() for ln in kernel.build_log.splitlines() if "registers" in ln]
        print(json.dumps({"variant": name, "change": VARIANTS[name][1], **times, "same_bits": ok,
                          "ptxas": regs}), flush=True)
        if not ok:
            raise AssertionError(f"variant {name} changed the bits")
    both = lambda: ssim_ops.ssim_backward(x, y, cot)
    dx_only = lambda: ssim_ops.ssim_backward(x, y, cot, with_dy=False)
    times = alternate(both, dx_only)
    ok = torch.equal(dx_only()[0], both()[0])
    print(json.dumps({"variant": "D_dx_only", "change": "dy not computed (the training path)",
                      **times, "same_bits": ok}), flush=True)
    if not ok:
        raise AssertionError("dx without dy changed the bits")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip())


if __name__ == "__main__":
    main()
