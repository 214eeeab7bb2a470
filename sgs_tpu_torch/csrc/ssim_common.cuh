// Shared pieces of the SSIM kernels (ssim.cu, Kernel B; ssim_backward.cu,
// Kernel D): the window, the tile load and the 11-tap passes.
//
// Every window sum runs k = 0..10 from 0.0f in the plain version's order
// (`_conv1d_axis` in ops/ssim.py), and the files are built with
// --fmad=false, so each statistic rounds exactly as the plain version's.
//
// The passes slide: a thread owns a strip of S consecutive outputs along
// one axis, reads each of the S + 10 inputs once from shared memory into
// registers and adds it into the up to 11 outputs it touches (output o
// takes input j as tap j - o, so each output still receives its taps in
// order). Along H a warp's threads hold neighbouring columns; along W
// they hold neighbouring rows of a buffer whose pitch is odd, so neither
// pass has bank conflicts.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ssim {

constexpr int kWin = 11;
constexpr int kPad = kWin / 2;
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);

struct Window {
  float w[kWin];
};

__host__ __device__ constexpr int round_up(int n, int s) { return (n + s - 1) / s * s; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int odd(int n) { return n | 1; }

// Rows [row0, row0 + rows) and columns [col0, col0 + cols) of one plane of
// x and y into shared memory at `pitch`, zeros outside the image. col0 and
// cols are multiples of 4, so where the width is too and the planes are
// 16-byte aligned every float4 lies wholly inside or wholly outside the
// image and the loads are aligned 16-byte loads.
__device__ __forceinline__ void load_pair(const float* __restrict__ xc, const float* __restrict__ yc,
                                          int height, int width, int row0, int col0, int rows,
                                          int cols, int pitch, float* sx, float* sy)
{
  const bool vec = (width & 3) == 0 && ((reinterpret_cast<uintptr_t>(xc) |
                                         reinterpret_cast<uintptr_t>(yc)) & 15) == 0;
  if (vec) {
    const int quads = cols / 4;
    for (int i = threadIdx.x; i < rows * quads; i += blockDim.x) {
      const int r = i / quads, q = 4 * (i % quads);
      const int gr = row0 + r, gq = col0 + q;
      float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = a;
      if (gr >= 0 && gr < height && gq >= 0 && gq < width) {
        const size_t off = (size_t)gr * width + gq;
        a = *reinterpret_cast<const float4*>(xc + off);
        b = *reinterpret_cast<const float4*>(yc + off);
      }
      float* px = sx + r * pitch + q;
      float* py = sy + r * pitch + q;
      px[0] = a.x; px[1] = a.y; px[2] = a.z; px[3] = a.w;
      py[0] = b.x; py[1] = b.y; py[2] = b.z; py[3] = b.w;
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, q = i % cols;
      const int gr = row0 + r, gq = col0 + q;
      const bool in = gr >= 0 && gr < height && gq >= 0 && gq < width;
      const size_t off = (size_t)gr * width + gq;
      sx[r * pitch + q] = in ? xc[off] : 0.0f;
      sy[r * pitch + q] = in ? yc[off] : 0.0f;
    }
  }
}

// The first pass of the statistics: x, y, x^2, y^2 and xy through the
// window along one axis, for S outputs; px and py point at the first
// input, `step` apart. Each product is formed once per value read.
template <int S>
__device__ __forceinline__ void slide_stats(const float* px, const float* py, int step,
                                            const Window& win, float (&acc)[5][S])
{
#pragma unroll
  for (int o = 0; o < S; ++o)
#pragma unroll
    for (int m = 0; m < 5; ++m) acc[m][o] = 0.0f;
#pragma unroll
  for (int j = 0; j < S + kWin - 1; ++j) {
    const float vx = px[j * step], vy = py[j * step];
    const float v[5] = {vx, vy, vx * vx, vy * vy, vx * vy};
#pragma unroll
    for (int o = 0; o < S; ++o) {
      const int k = j - o;
      if (k >= 0 && k < kWin) {
#pragma unroll
        for (int m = 0; m < 5; ++m) acc[m][o] += win.w[k] * v[m];
      }
    }
  }
}

// M maps through the window along one axis, for S outputs; map m starts
// at src + m * map_stride, inputs `step` apart.
template <int M, int S>
__device__ __forceinline__ void slide(const float* src, int map_stride, int step,
                                      const Window& win, float (&acc)[M][S])
{
#pragma unroll
  for (int o = 0; o < S; ++o)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[m][o] = 0.0f;
#pragma unroll
  for (int j = 0; j < S + kWin - 1; ++j) {
    float v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = src[m * map_stride + j * step];
#pragma unroll
    for (int o = 0; o < S; ++o) {
      const int k = j - o;
      if (k >= 0 && k < kWin) {
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m][o] += win.w[k] * v[m];
      }
    }
  }
}

}  // namespace ssim
