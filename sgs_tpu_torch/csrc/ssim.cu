// SSIM forward: mean SSIM of a (3, H, W) image pair with the reference's
// 11-tap, sigma 1.5 separable Gaussian window and zero padding.
//
// Replaces the TPU kernels sgs_tpu/ops/pallas/ssim_kernels.py::ssim_forward
// (_fwd1_kernel: products and one 1-D pass; _fwd2_kernel: the other pass,
// the SSIM map and masked partial sums). The TPU version streams row
// blocks with shifted-BlockSpec halos and transposes in between because
// lane rolls are costly there. Here one block owns a 16x16 output tile of
// one channel: it loads the tile plus a 5-pixel halo of x and y into
// shared memory (zeros outside the image), forms x, y, x^2, y^2 and xy,
// runs the 11-tap pass along W and then along H in shared memory, forms
// the SSIM map and writes one partial sum. A second kernel of one block
// sums the partials in a fixed order, so the mean is bitwise the same
// from run to run: no float atomics.
//
// The file is built with --fmad=false and sums the taps in the plain
// version's order, so every map value rounds as the plain PyTorch
// version's does: sigma = E[x^2] - mu^2 cancels badly on flat regions of
// quantised images, and contracted multiply-adds there moved the mean of
// an 800x800 pair by 2e-5 relative.
//
// Bound: about 240 f32 operations per pixel and channel against 8 bytes
// of input, so at 800x800 the work is bound by operations more than by
// bytes. The 15-channel residual P_h_t that the TPU forward also returns
// feeds only the backward kernel and is not produced here.

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
ssim_partials_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     int height, int width, Window win, float* __restrict__ partials)
{
  __shared__ float sx[kSpan][kSpan];
  __shared__ float sy[kSpan][kSpan];
  __shared__ float sh[5][kSpan][kTile];
  __shared__ float red[kThreads];

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

  // pass along W for every halo row
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

  // pass along H, then the SSIM map for this thread's pixel
  const int ly = t / kTile, lx = t % kTile;
  float m[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < kWin; ++k) {
    const float wk = win.w[k];
#pragma unroll
    for (int p = 0; p < 5; ++p) m[p] += wk * sh[p][ly + k][lx];
  }
  const int gy = blockIdx.y * kTile + ly, gx = blockIdx.x * kTile + lx;
  float val = 0.0f;
  if (gy < height && gx < width) {
    const float mu1 = m[0], mu2 = m[1];
    const float mu1_sq = mu1 * mu1, mu2_sq = mu2 * mu2, mu1_mu2 = mu1 * mu2;
    const float sigma1_sq = m[2] - mu1_sq;
    const float sigma2_sq = m[3] - mu2_sq;
    const float sigma12 = m[4] - mu1_mu2;
    val = ((2.0f * mu1_mu2 + kC1) * (2.0f * sigma12 + kC2)) /
          ((mu1_sq + mu2_sq + kC1) * (sigma1_sq + sigma2_sq + kC2));
  }

  red[t] = val;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) {
    const int blocks = gridDim.x * gridDim.y;
    partials[c * blocks + blockIdx.y * gridDim.x + blockIdx.x] = red[0];
  }
}

constexpr int kReduceThreads = 1024;

__global__ void __launch_bounds__(kReduceThreads)
ssim_reduce_kernel(const float* __restrict__ partials, int n, float count,
                   float* __restrict__ out)
{
  __shared__ float red[kReduceThreads];
  const int t = threadIdx.x;
  float s = 0.0f;
  for (int i = t; i < n; i += kReduceThreads) s += partials[i];
  red[t] = s;
  __syncthreads();
  for (int k = kReduceThreads / 2; k > 0; k >>= 1) {
    if (t < k) red[t] += red[t + k];
    __syncthreads();
  }
  if (t == 0) out[0] = red[0] / count;
}

}  // namespace

extern "C" int ssim_partials(void* x, void* y, int height, int width,
                             const float* window, void* partials, void* stream)
{
  Window win;
  for (int k = 0; k < kWin; ++k) win.w[k] = window[k];
  dim3 grid((width + kTile - 1) / kTile, (height + kTile - 1) / kTile, 3);
  ssim_partials_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, height, width, win, (float*)partials);
  return (int)cudaGetLastError();
}

extern "C" int ssim_reduce(void* partials, int n, float count, void* out, void* stream)
{
  ssim_reduce_kernel<<<1, kReduceThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partials, n, count, (float*)out);
  return (int)cudaGetLastError();
}
