// SSIM forward (Kernel B): mean SSIM of a (3, H, W) image pair with the
// reference's 11-tap, sigma 1.5 separable Gaussian window and zero
// padding, in one launch.
//
// Replaces the TPU kernels sgs_tpu/ops/pallas/ssim_kernels.py::ssim_forward
// (_fwd1_kernel: products and one 1-D pass; _fwd2_kernel: the other pass,
// the SSIM map and masked partial sums). The TPU version streams row
// blocks with shifted-BlockSpec halos and transposes in between because
// lane rolls are costly there. Here one block of 384 threads owns a 48x32
// (rows x columns) output tile of one channel: x and y plus a 5-pixel
// halo into shared memory (zeros outside the image), the statistics by
// the sliding passes of ssim_common.cuh (the first half of Kernel D), W
// then H, and the SSIM map. The tile and the strips were chosen by
// measurement (tools/ssim_ablation.py times the alternatives).
//
// The sum has a fixed order, so the mean is bitwise the same from run to
// run and equals ssim_plain's: each thread adds its strip of 4 rows of one
// column, the 32 lanes (columns) meet in an xor butterfly, the 12 warps
// are added in order; the last block to finish (an integer ticket, no
// float atomics) sums the per-tile partials the same way, thread t taking
// partials t, t + 384, ... in turn, and divides by 3 H W. ops/ssim.py's
// TILE_H, TILE_W and THREADS must match the constants below.
//
// The file is built with --fmad=false and sums the taps in the plain
// version's order, so every map value rounds as the plain PyTorch
// version's does: sigma = E[x^2] - mu^2 cancels badly on flat regions of
// quantised images, and contracted multiply-adds there moved the mean of
// an 800x800 pair by 2e-5 relative.
//
// Bound: about 240 f32 operations per pixel and channel against 8 bytes
// of input, so at 800x800 the work is bound by operations more than by
// bytes; without contracted multiply-adds the kernel can reach at most
// about half of that bound. The 15-channel residual P_h_t that the TPU
// forward also returns feeds only the backward kernel and is not produced
// here.

#include "ssim_common.cuh"

namespace {

using namespace ssim;

constexpr int kTileH = 48;
constexpr int kTileW = 32;
constexpr int kThreads = 384;
constexpr int kWarps = kThreads / 32;
constexpr int kStripW = 4;                // outputs per thread along W
constexpr int kStripH = kTileH / kWarps;  // rows per thread along H: one strip per warp
constexpr unsigned kFull = 0xffffffffu;
static_assert(kTileW == 32 && kTileH % kWarps == 0,
              "ssim_plain's order: lanes along W, one strip of rows per warp");

constexpr int kLeft = round_up(kPad, 4);  // input columns left of the tile, 16-byte aligned
constexpr int kInRows = kTileH + 2 * kPad;
constexpr int kInCols = round_up(kLeft + kTileW + kPad, 4);
constexpr int kWCols = round_up(kTileW, kStripW);
constexpr int kInPitch = odd(cmax(kInCols, kLeft - kPad + kWCols + kWin - 1));
constexpr int kHPitch = odd(kWCols);
constexpr int kHMap = kInRows * kHPitch;
constexpr size_t kSmemBytes = sizeof(float) * (2 * kInRows * kInPitch + 5 * kHMap);

// Sum of v over the block, valid in thread 0: an xor butterfly in each
// warp, then the warps in order from 0.0f.
__device__ __forceinline__ float block_sum(float v, float* red)
{
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The mean of n partials: thread t adds partials t, t + kThreads, ... in
// turn, then block_sum, then one division.
__device__ __forceinline__ void final_sum(const float* partials, int n, float count, float* red,
                                          float* out)
{
  float a = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) a += __ldcg(partials + i);
  a = block_sum(a, red);
  if (threadIdx.x == 0) out[0] = a / count;
}

// Calls on two streams at once must not share `ticket`: it counts the
// blocks of one launch, and the last block resets it to 0.
__global__ void __launch_bounds__(kThreads)
ssim_forward_kernel(const float* __restrict__ x, const float* __restrict__ y, int height,
                    int width, Window win, float count, float* __restrict__ partials,
                    unsigned* __restrict__ ticket, float* __restrict__ out)
{
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = sx + kInRows * kInPitch;
  float* sh = sy + kInRows * kInPitch;
  __shared__ float red[kWarps];
  __shared__ bool last;

  const int c = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const size_t plane = (size_t)height * width;
  load_pair(x + c * plane, y + c * plane, height, width, ty0 - kPad, tx0 - kLeft, kInRows,
            kInCols, kInPitch, sx, sy);
  __syncthreads();

  // the statistics along W, on every input row and the tile's columns
  for (int i = threadIdx.x; i < kInRows * (kWCols / kStripW); i += kThreads) {
    const int r = i % kInRows, q0 = (i / kInRows) * kStripW;
    const int off = r * kInPitch + kLeft - kPad + q0;
    float acc[5][kStripW];
    slide_stats<kStripW>(sx + off, sy + off, 1, win, acc);
#pragma unroll
    for (int m = 0; m < 5; ++m)
#pragma unroll
      for (int o = 0; o < kStripW; ++o) sh[m * kHMap + r * kHPitch + q0 + o] = acc[m][o];
  }
  __syncthreads();

  // along H: thread t takes column t % 32 and rows kStripH * (t / 32) on
  const int q = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * kStripH;
  float m[5][kStripH];
  slide<5, kStripH>(sh + r0 * kHPitch + q, kHMap, kHPitch, win, m);
  const int gx = tx0 + q;
  float s = 0.0f;
#pragma unroll
  for (int o = 0; o < kStripH; ++o) {
    const int gy = ty0 + r0 + o;
    float val = 0.0f;
    if (gy < height && gx < width) {
      const float mu1 = m[0][o], mu2 = m[1][o];
      const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
      const float sigma1_sq = m[2][o] - mu1_sq;
      const float sigma2_sq = m[3][o] - mu2_sq;
      const float sigma12 = m[4][o] - mu1_mu2;
      val = ((2.0f * mu1_mu2 + kC1) * (2.0f * sigma12 + kC2)) /
            ((mu1_sq + mu2_sq + kC1) * (sigma1_sq + sigma2_sq + kC2));
    }
    s += val;
  }
  s = block_sum(s, red);

  const int blocks = gridDim.x * gridDim.y * gridDim.z;
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

}  // namespace

extern "C" int ssim_forward(void* x, void* y, int height, int width, const float* window,
                            float count, void* partials, void* ticket, void* out, void* stream)
{
  Window win;
  for (int k = 0; k < kWin; ++k) win.w[k] = window[k];
  const cudaError_t err = cudaFuncSetAttribute(
      ssim_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, 3);
  ssim_forward_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, height, width, win, count, (float*)partials,
      (unsigned*)ticket, (float*)out);
  return (int)cudaGetLastError();
}
