// SSIM backward (Kernel D): the gradient of mean SSIM over a (3, H, W)
// image pair with respect to x (and y, when asked), scaled by the
// cotangent of the mean.
//
// Replaces the TPU kernels sgs_tpu/ops/pallas/ssim_kernels.py::
// ssim_backward (_gmap_kernel, _conv15_kernel, _bwd2_kernel). The TPU
// pairing hands a (15, Wp, Hp) residual P_h_t from the forward to the
// backward; here the backward recomputes the windowed statistics from x
// and y, and one launch does all of it without a map in device memory.
//
// One block of 512 threads owns a 48x32 (rows x columns) output tile of
// one channel; the tile size and the strips below were chosen by
// measurement (tools/ssim_ablation.py times the alternatives):
//   1. x and y for the tile plus a 10-pixel halo (two windows) into shared
//      memory, zeros outside the image;
//   2. the statistics mu_x, mu_y, E[x^2], E[y^2], E[xy] on the tile plus a
//      5-pixel ring: the window along W on every loaded row, then along H;
//   3. on that ring, the pointwise partials of the SSIM map with respect to
//      the statistics (the formulas of _gmap_kernel), zero outside the
//      image, where the plain version zero-pads the partial maps. The
//      partials for E[x^2] and E[y^2] are the same map, so four maps go on
//      (ga, gc, ge, gb), three when dy is not wanted;
//   4. those maps through the window (it is symmetric, so the transposed
//      convolution is the convolution), W then H, onto the tile;
//   5. dx = A' + 2 x C' + y E' and dy = B' + 2 y C' + x E' (the
//      combination of _bwd2_kernel), times cot / (3 H W).
// The ring costs recomputed statistics (58x42 against 48x32 pixels per
// tile) and saves the maps that two launches would write and read back
// (four (3, H, W) maps, 30.7 MB at 800x800).
//
// Built with --fmad=false and with every sum in the plain version's order:
// E[x^2] - mu^2 cancels on flat regions of quantised images. The result
// equals ssim_backward_plain bit for bit.
//
// Bound: about 500 f32 operations per pixel and channel (240 to compute
// the statistics, about 30 for the partials, 220 for the second pair of
// window passes, 8 to combine) against 16 bytes read and written, so the
// work is bound by operations. Without contracted multiply-adds each
// operation is one instruction, so the kernel can reach at most about half
// of the operations bound stated at the FMA rate.

#include "ssim_common.cuh"

namespace {

using namespace ssim;

constexpr int kTileH = 48;
constexpr int kTileW = 32;
constexpr int kThreads = 512;
// outputs per thread in the four window passes
constexpr int kStripW1 = 6;
constexpr int kStripH1 = 5;
constexpr int kStripW2 = 8;
constexpr int kStripH2 = 4;

constexpr int kHalo = 2 * kPad;
constexpr int kRingH = kTileH + 2 * kPad;  // statistics and partials
constexpr int kRingW = kTileW + 2 * kPad;
constexpr int kLeft = round_up(kHalo, 4);  // input columns left of the tile, 16-byte aligned
constexpr int kInRows = kTileH + 2 * kHalo;
constexpr int kInCols = round_up(kLeft + kTileW + kHalo, 4);
constexpr int kW1Cols = round_up(kRingW, kStripW1);
constexpr int kW2Cols = round_up(kTileW, kStripW2);
// Buffers are sized for whole strips: a last strip that runs past the
// region reads and computes values that are never stored or used.
constexpr int kInPitch = odd(cmax(kInCols, kLeft - kHalo + kW1Cols + kWin - 1));
constexpr int kH1Rows = cmax(kInRows, round_up(kRingH, kStripH1) + kWin - 1);
constexpr int kH1Pitch = odd(kW1Cols);
constexpr int kH1Map = kH1Rows * kH1Pitch;
constexpr int kGPitch = odd(cmax(kRingW, kW2Cols + kWin - 1));
constexpr int kGMap = kRingH * kGPitch;
constexpr int kH2Rows = cmax(kRingH, round_up(kTileH, kStripH2) + kWin - 1);
constexpr int kH2Pitch = odd(kW2Cols);
constexpr int kH2Map = kH2Rows * kH2Pitch;
constexpr int kStripsH1 = (kRingH + kStripH1 - 1) / kStripH1;
constexpr int kStripsH2 = (kTileH + kStripH2 - 1) / kStripH2;
// shared memory: A holds x and y, later the partial maps; B holds the
// first W pass of the statistics, later that of the partials
constexpr int kBufA = cmax(2 * kInRows * kInPitch, 4 * kGMap);
constexpr int kBufB = cmax(5 * kH1Map, 4 * kH2Map);
constexpr size_t kSmemBytes = sizeof(float) * (kBufA + kBufB);

template <bool kDy>
__global__ void __launch_bounds__(kThreads)
ssim_backward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     const float* __restrict__ cot, float count, int height, int width,
                     Window win, float* __restrict__ dx, float* __restrict__ dy)
{
  constexpr int kMaps = kDy ? 4 : 3;
  extern __shared__ float smem[];
  float* sx = smem;
  float* sy = smem + kInRows * kInPitch;
  float* g = smem;
  float* h1 = smem + kBufA;
  float* h2 = h1;

  const int c = blockIdx.z;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const size_t plane = (size_t)height * width;
  load_pair(x + c * plane, y + c * plane, height, width, ty0 - kHalo, tx0 - kLeft, kInRows,
            kInCols, kInPitch, sx, sy);
  __syncthreads();

  // the statistics along W, on every input row and the ring's columns
  for (int i = threadIdx.x; i < kInRows * (kW1Cols / kStripW1); i += kThreads) {
    const int r = i % kInRows, q0 = (i / kInRows) * kStripW1;
    const int off = r * kInPitch + kLeft - kHalo + q0;
    float acc[5][kStripW1];
    slide_stats<kStripW1>(sx + off, sy + off, 1, win, acc);
#pragma unroll
    for (int m = 0; m < 5; ++m)
#pragma unroll
      for (int o = 0; o < kStripW1; ++o) h1[m * kH1Map + r * kH1Pitch + q0 + o] = acc[m][o];
  }
  __syncthreads();

  // along H on the ring, then the partials (x and y are spent: g reuses them)
  for (int i = threadIdx.x; i < kRingW * kStripsH1; i += kThreads) {
    const int q = i % kRingW, r0 = (i / kRingW) * kStripH1;
    float acc[5][kStripH1];
    slide<5, kStripH1>(h1 + r0 * kH1Pitch + q, kH1Map, kH1Pitch, win, acc);
    const int gx = tx0 - kPad + q;
#pragma unroll
    for (int o = 0; o < kStripH1; ++o) {
      const int r = r0 + o, gy = ty0 - kPad + r;
      if (r >= kRingH) break;
      float ga = 0.0f, gb = 0.0f, gc = 0.0f, ge = 0.0f;
      if (gy >= 0 && gy < height && gx >= 0 && gx < width) {
        const float a = acc[0][o], b = acc[1][o], cc = acc[2][o], d = acc[3][o], e = acc[4][o];
        const float n1 = 2.0f * a * b + kC1;
        const float n2 = 2.0f * (e - a * b) + kC2;
        const float d1 = a * a + b * b + kC1;
        const float d2 = (cc - a * a) + (d - b * b) + kC2;
        const float inv = 1.0f / (d1 * d2);
        const float mp = n1 * n2 * inv;
        ga = 2.0f * b * (n2 - n1) * inv - mp * (2.0f * a / d1 - 2.0f * a / d2);
        if (kDy) gb = 2.0f * a * (n2 - n1) * inv - mp * (2.0f * b / d1 - 2.0f * b / d2);
        gc = -mp / d2;
        ge = 2.0f * n1 * inv;
      }
      float* out = g + r * kGPitch + q;
      out[0] = ga;
      out[kGMap] = gc;
      out[2 * kGMap] = ge;
      if (kDy) out[3 * kGMap] = gb;
    }
  }
  __syncthreads();

  // the partials along W, on every ring row and the tile's columns
  for (int i = threadIdx.x; i < kRingH * (kW2Cols / kStripW2); i += kThreads) {
    const int r = i % kRingH, q0 = (i / kRingH) * kStripW2;
    float acc[kMaps][kStripW2];
    slide<kMaps, kStripW2>(g + r * kGPitch + q0, kGMap, 1, win, acc);
#pragma unroll
    for (int m = 0; m < kMaps; ++m)
#pragma unroll
      for (int o = 0; o < kStripW2; ++o) h2[m * kH2Map + r * kH2Pitch + q0 + o] = acc[m][o];
  }
  __syncthreads();

  // along H on the tile, and the combination
  const float scale = cot[0] / count;
  for (int i = threadIdx.x; i < kTileW * kStripsH2; i += kThreads) {
    const int q = i % kTileW, r0 = (i / kTileW) * kStripH2;
    float acc[kMaps][kStripH2];
    slide<kMaps, kStripH2>(h2 + r0 * kH2Pitch + q, kH2Map, kH2Pitch, win, acc);
    const int gx = tx0 + q;
#pragma unroll
    for (int o = 0; o < kStripH2; ++o) {
      const int gy = ty0 + r0 + o;
      if (r0 + o < kTileH && gy < height && gx < width) {
        const size_t off = c * plane + (size_t)gy * width + gx;
        const float vx = x[off], vy = y[off];
        dx[off] = (acc[0][o] + 2.0f * vx * acc[1][o] + vy * acc[2][o]) * scale;
        if (kDy) dy[off] = (acc[3][o] + 2.0f * vy * acc[1][o] + vx * acc[2][o]) * scale;
      }
    }
  }
}

template <bool kDy>
int launch(const float* x, const float* y, const float* cot, float count, int height, int width,
           const Window& win, float* dx, float* dy, cudaStream_t stream)
{
  const cudaError_t err = cudaFuncSetAttribute(
      ssim_backward_kernel<kDy>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH, 3);
  ssim_backward_kernel<kDy><<<grid, kThreads, kSmemBytes, stream>>>(x, y, cot, count, height,
                                                                    width, win, dx, dy);
  return (int)cudaGetLastError();
}

}  // namespace

// dy may be null: then only dx is computed.
extern "C" int ssim_backward(void* x, void* y, void* cot, float count, int height, int width,
                             const float* window, void* dx, void* dy, void* stream)
{
  Window win;
  for (int k = 0; k < kWin; ++k) win.w[k] = window[k];
  if (dy == nullptr)
    return launch<false>((const float*)x, (const float*)y, (const float*)cot, count, height, width,
                         win, (float*)dx, nullptr, (cudaStream_t)stream);
  return launch<true>((const float*)x, (const float*)y, (const float*)cot, count, height, width,
                      win, (float*)dx, (float*)dy, (cudaStream_t)stream);
}
