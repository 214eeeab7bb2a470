// SSIM backward (Kernel D): the gradient of mean SSIM over a (3, H, W)
// image pair with respect to both images, scaled by the cotangent of the
// mean.
//
// Replaces the TPU kernels sgs_tpu/ops/pallas/ssim_kernels.py::
// ssim_backward (_gmap_kernel, _conv15_kernel, _bwd2_kernel). The TPU
// pairing hands a (15, Wp, Hp) residual P_h_t from the forward to the
// backward and streams transposed row blocks with shifted-BlockSpec halos;
// here the backward recomputes the windowed statistics from x and y
// instead (at 800x800 P_h_t would be 38.4 MB written and read again per
// step, against 15 MB of x and y), and each launch works on 16x16 output
// tiles with a 5-pixel halo in shared memory.
//
// D1 (ssim_gmap_kernel): per tile and channel, x and y plus halo into
// shared memory (zeros outside the image), the 11-tap window along W and
// then along H for x, y, x^2, y^2 and xy (Kernel B's arithmetic), then the
// pointwise partials of the SSIM map with respect to the five statistics
// A = mu_x, B = mu_y, C = E[x^2], D = E[y^2], E = E[xy] (the formulas of
// _gmap_kernel), written to a (5, 3, H, W) map.
// D2 (ssim_combine_kernel): per tile and channel, the five partial maps
// plus halo (zero padding) through the same window, W then H (the window
// is symmetric, so the transposed convolution is the convolution), then
// dx = A' + 2 x C' + y E', dy = B' + 2 y D' + x E' (the combination of
// _bwd2_kernel), times cot / (3 H W).
//
// Built with --fmad=false and with every sum in the plain version's order:
// E[x^2] - mu^2 cancels on flat regions of quantised images.
//
// Bound: about 500 f32 operations per pixel and channel (240 to recompute
// the statistics, about 30 for the partials, 220 for the second pair of
// window passes, 8 to combine) against 16 bytes read and written, so the
// work is bound by operations rather than bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kWin = 11;
constexpr int kPad = kWin / 2;
constexpr int kSpan = kTile + 2 * kPad;  // 26
constexpr int kThreads = kTile * kTile;
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

struct Window {
  float w[kWin];
};

__global__ void __launch_bounds__(kThreads)
ssim_gmap_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 int height, int width, Window win, float* __restrict__ gmap)
{
  __shared__ float sx[kSpan][kSpan];
  __shared__ float sy[kSpan][kSpan];
  __shared__ float sh[5][kSpan][kTile];

  const int t = threadIdx.x;
  const int c = blockIdx.z;
  const int row0 = blockIdx.y * kTile - kPad;
  const int col0 = blockIdx.x * kTile - kPad;
  const size_t plane = (size_t)height * width;
  const float* xc = x + c * plane;
  const float* yc = y + c * plane;

  for (int i = t; i < kSpan * kSpan; i += kThreads) {
    const int r = i / kSpan, q = i % kSpan;
    const int gr = row0 + r, gq = col0 + q;
    const bool in = gr >= 0 && gr < height && gq >= 0 && gq < width;
    sx[r][q] = in ? xc[(size_t)gr * width + gq] : 0.0f;
    sy[r][q] = in ? yc[(size_t)gr * width + gq] : 0.0f;
  }
  __syncthreads();

  for (int i = t; i < kSpan * kTile; i += kThreads) {
    const int r = i / kTile, q = i % kTile;
    float a = 0.0f, b = 0.0f, cxx = 0.0f, cyy = 0.0f, cxy = 0.0f;
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const float vx = sx[r][q + k];
      const float vy = sy[r][q + k];
      const float wk = win.w[k];
      a += wk * vx;
      b += wk * vy;
      cxx += wk * (vx * vx);
      cyy += wk * (vy * vy);
      cxy += wk * (vx * vy);
    }
    sh[0][r][q] = a;
    sh[1][r][q] = b;
    sh[2][r][q] = cxx;
    sh[3][r][q] = cyy;
    sh[4][r][q] = cxy;
  }
  __syncthreads();

  const int ly = t / kTile, lx = t % kTile;
  float m[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
    const float wk = win.w[k];
#pragma unroll
    for (int p = 0; p < 5; ++p) m[p] += wk * sh[p][ly + k][lx];
  }
  const int gy = blockIdx.y * kTile + ly, gx = blockIdx.x * kTile + lx;
  if (gy < height && gx < width) {
    const float a = m[0], b = m[1], cc = m[2], d = m[3], e = m[4];
    const float n1 = 2.0f * a * b + kC1;
    const float n2 = 2.0f * (e - a * b) + kC2;
    const float d1 = a * a + b * b + kC1;
    const float d2 = (cc - a * a) + (d - b * b) + kC2;
    const float inv = 1.0f / (d1 * d2);
    const float mp = n1 * n2 * inv;
    const float ga = 2.0f * b * (n2 - n1) * inv - mp * (2.0f * a / d1 - 2.0f * a / d2);
    const float gb = 2.0f * a * (n2 - n1) * inv - mp * (2.0f * b / d1 - 2.0f * b / d2);
    const float gc = -mp / d2;
    const float ge = 2.0f * n1 * inv;
    const size_t pix = (size_t)gy * width + gx;
    const size_t stride = 3 * plane;
    float* out = gmap + c * plane + pix;
    out[0] = ga;
    out[stride] = gb;
    out[2 * stride] = gc;
    out[3 * stride] = gc;
    out[4 * stride] = ge;
  }
}

__global__ void __launch_bounds__(kThreads)
ssim_combine_kernel(const float* __restrict__ gmap, const float* __restrict__ x,
                    const float* __restrict__ y, const float* __restrict__ cot,
                    float count, int height, int width, Window win,
                    float* __restrict__ dx, float* __restrict__ dy)
{
  __shared__ float sg[5][kSpan][kSpan];
  __shared__ float sh[5][kSpan][kTile];

  const int t = threadIdx.x;
  const int c = blockIdx.z;
  const int row0 = blockIdx.y * kTile - kPad;
  const int col0 = blockIdx.x * kTile - kPad;
  const size_t plane = (size_t)height * width;
  const size_t stride = 3 * plane;

  for (int i = t; i < kSpan * kSpan; i += kThreads) {
    const int r = i / kSpan, q = i % kSpan;
    const int gr = row0 + r, gq = col0 + q;
    const bool in = gr >= 0 && gr < height && gq >= 0 && gq < width;
    const size_t off = c * plane + (size_t)gr * width + gq;
#pragma unroll
    for (int p = 0; p < 5; ++p) sg[p][r][q] = in ? gmap[p * stride + off] : 0.0f;
  }
  __syncthreads();

  for (int i = t; i < kSpan * kTile; i += kThreads) {
    const int r = i / kTile, q = i % kTile;
    float acc[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kWin; ++k) {
      const float wk = win.w[k];
#pragma unroll
      for (int p = 0; p < 5; ++p) acc[p] += wk * sg[p][r][q + k];
    }
#pragma unroll
    for (int p = 0; p < 5; ++p) sh[p][r][q] = acc[p];
  }
  __syncthreads();

  const int ly = t / kTile, lx = t % kTile;
  float m[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
    const float wk = win.w[k];
#pragma unroll
    for (int p = 0; p < 5; ++p) m[p] += wk * sh[p][ly + k][lx];
  }
  const int gy = blockIdx.y * kTile + ly, gx = blockIdx.x * kTile + lx;
  if (gy < height && gx < width) {
    const size_t off = c * plane + (size_t)gy * width + gx;
    const float vx = x[off], vy = y[off];
    const float scale = cot[0] / count;
    dx[off] = (m[0] + 2.0f * vx * m[2] + vy * m[4]) * scale;
    dy[off] = (m[1] + 2.0f * vy * m[3] + vx * m[4]) * scale;
  }
}

}  // namespace

extern "C" int ssim_gmap(void* x, void* y, int height, int width, const float* window,
                         void* gmap, void* stream)
{
  Window win;
  for (int k = 0; k < kWin; ++k) win.w[k] = window[k];
  dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, 3);
  ssim_gmap_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, height, width, win, (float*)gmap);
  return (int)cudaGetLastError();
}

extern "C" int ssim_combine(void* gmap, void* x, void* y, void* cot, float count,
                            int height, int width, const float* window,
                            void* dx, void* dy, void* stream)
{
  Window win;
  for (int k = 0; k < kWin; ++k) win.w[k] = window[k];
  dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, 3);
  ssim_combine_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)gmap, (const float*)x, (const float*)y, (const float*)cot, count,
      height, width, win, (float*)dx, (float*)dy);
  return (int)cudaGetLastError();
}
