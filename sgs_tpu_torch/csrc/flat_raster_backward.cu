// Raster backward (Kernel C): the gradient of the tiled alpha compositing
// with respect to each Gaussian's pixel mean, conic, opacity and colour.
//
// Replaces the TPU kernel sgs_tpu/ops/pallas/flat_raster.py::backward_flat
// (_bwd_kernel_body, _row_lookup_bwd) and the XLA reduction after it
// (reduce_grads_presort). The TPU version walks 64-instance chunks of a
// padded row layout with Hillis-Steele cumprod/cumsum scans, moment
// matmuls on the MXU and CSR row tables; those are TPU layout devices and
// have no counterpart here.
//
// Launch 1 (flat_raster_backward_kernel): one 256-thread block per 16x16
// tile, one thread per pixel, as in the forward kernel. The block walks
// its tile's depth-ordered list back to front, from the largest n_contrib
// of its pixels down to 0, in shared-memory batches of kBatch records.
// Each pixel starts from its forward state: T = t_final and the suffix
// S = dC . (colour composited behind the current instance), which starts
// at t_final * (dC . bg), so the background enters dL/dalpha. For each
// instance at a position below its n_contrib it recomputes power and
// alpha with exactly Kernel A's expression (built with --fmad=false, so
// the include and clamp branches agree bit for bit), recovers the
// transmittance in front of the instance by T_i = T / (1 - alpha), and
// forms
//   dL/dalpha = T_i (dC . c) - S / (1 - alpha),  zero where q >= 0.99,
//   g_power   = q dL/dalpha  (q = opacity * exp(power)),
// and the 9 per-pixel terms g_power, dx g_power, dy g_power, dx dx g_power,
// dx dy g_power, dy dy g_power and T_i alpha dC. Each term is summed over
// the tile's 256 pixels in a fixed order (xor shuffles inside each warp,
// then the 8 warps in order), and one thread per instance turns the sums
// into the 9 gradient components [d mean x, d mean y, d conic a, b, c,
// d opacity, d r, g, b] and writes them at the instance's depth-rank-major
// ("presort") position perm[i]. Instances past the tile's largest
// n_contrib get zeros.
//
// Launch 2 (flat_raster_reduce_kernel): one thread per depth rank. In
// presort order every Gaussian's instances are contiguous, so the thread
// sums its run [rank_start[j], rank_start[j + 1]) in order and writes the
// result to Gaussian order[j]. No float atomics: two runs give the same
// bits.
//
// Bound: like the forward, the walk is bound by operations (about 50 f32
// operations per instance-pixel pair it walks, counting the recomputed
// forward terms and the 9 reduction adds) rather than bytes (40 bytes of
// record per instance and tile, 20 bytes per pixel, 36 bytes written per
// instance). The design keeps the per-pixel state in registers, the
// records in shared memory, and does the block reduction with shuffles;
// the per-warp partials go through shared memory once per batch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kWarps = kBlock / 32;
constexpr int kBatch = 32;
constexpr int kTerms = 9;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = (float)(1.0 / 255.0);

__global__ void __launch_bounds__(kBlock)
flat_raster_backward_kernel(
    const int32_t* __restrict__ tile_start,   // (T,)
    const int32_t* __restrict__ tile_end,     // (T,)
    const int32_t* __restrict__ point_list,   // (M,) Gaussian ids, tile-sorted
    const int64_t* __restrict__ perm,         // (M,) presort position of each instance
    const float2* __restrict__ xy,            // (N,)
    const float4* __restrict__ conic_op,      // (N,)
    const float* __restrict__ rgb,            // (N, 3)
    const float* __restrict__ t_final,        // (H, W)
    const int32_t* __restrict__ n_contrib,    // (H, W)
    const float* __restrict__ dc,             // (3, H, W) image cotangent
    const float* __restrict__ bg,             // (3,)
    int width, int height, int tiles_x,
    float* __restrict__ inst_grads)           // (M, 9), presort order
{
  __shared__ float2 s_xy[kBatch];
  __shared__ float4 s_co[kBatch];
  __shared__ float s_rgb[kBatch][3];
  __shared__ float s_part[kBatch][kWarps][kTerms];
  __shared__ int s_max;

  const int tile = blockIdx.y * tiles_x + blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int px = blockIdx.x * kTile + (t % kTile);
  const int py = blockIdx.y * kTile + (t / kTile);
  const bool inside = px < width && py < height;
  const float fx = (float)px;
  const float fy = (float)py;

  const int start = tile_start[tile];
  const int end = tile_end[tile];

  const int pix = py * width + px;
  const int plane = width * height;
  int last = 0;
  float T = 1.0f;
  float d0 = 0.0f, d1 = 0.0f, d2 = 0.0f;
  if (inside) {
    last = n_contrib[pix];
    T = t_final[pix];
    d0 = dc[pix];
    d1 = dc[plane + pix];
    d2 = dc[2 * plane + pix];
  }
  float S = T * (d0 * bg[0] + d1 * bg[1] + d2 * bg[2]);

  if (t == 0) s_max = 0;
  __syncthreads();
  if (last > 0) atomicMax(&s_max, last);
  __syncthreads();
  const int max_last = s_max;

  // instances no pixel of the tile composited carry zero gradients
  for (int i = start + max_last + t; i < end; i += kBlock) {
    float* out = inst_grads + perm[i] * kTerms;
#pragma unroll
    for (int k = 0; k < kTerms; ++k) out[k] = 0.0f;
  }

  for (int top = max_last; top > 0; top -= kBatch) {
    const int lo = max(top - kBatch, 0);
    const int batch = top - lo;
    __syncthreads();  // the previous batch's records and partials are consumed
    if (t < batch) {
      const int g = point_list[start + lo + t];
      s_xy[t] = xy[g];
      s_co[t] = conic_op[g];
      s_rgb[t][0] = rgb[3 * g + 0];
      s_rgb[t][1] = rgb[3 * g + 1];
      s_rgb[t][2] = rgb[3 * g + 2];
    }
    __syncthreads();
    for (int j = batch - 1; j >= 0; --j) {
      const int pos = lo + j;  // 0-based position in the tile's list
      float v[kTerms];
#pragma unroll
      for (int k = 0; k < kTerms; ++k) v[k] = 0.0f;
      if (pos < last) {
        const float2 m = s_xy[j];
        const float4 co = s_co[j];
        const float dx = m.x - fx;
        const float dy = m.y - fy;
        const float power = (-0.5f * co.x * dx - co.y * dy) * dx + (-0.5f * co.z) * dy * dy;
        const float q = co.w * expf(power);
        const float alpha = fminf(kAlphaMax, q);
        if (power <= 0.0f && alpha >= kAlphaMin) {
          const float u = 1.0f - alpha;
          const float t_i = T / u;
          const float dcc = d0 * s_rgb[j][0] + d1 * s_rgb[j][1] + d2 * s_rgb[j][2];
          const float w = t_i * alpha;
          const float g_alpha = t_i * dcc - S / u;
          S = S + w * dcc;
          T = t_i;
          const float g_power = q < kAlphaMax ? q * g_alpha : 0.0f;
          const float t1 = dx * g_power;
          const float t2 = dy * g_power;
          v[0] = g_power;
          v[1] = t1;
          v[2] = t2;
          v[3] = t1 * dx;
          v[4] = t1 * dy;
          v[5] = t2 * dy;
          v[6] = w * d0;
          v[7] = w * d1;
          v[8] = w * d2;
        }
      }
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
        float s = v[k];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        v[k] = s;
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kTerms; ++k) s_part[j][warp][k] = v[k];
      }
    }
    __syncthreads();
    if (t < batch) {
      float s[kTerms];
#pragma unroll
      for (int k = 0; k < kTerms; ++k) {
        float a = s_part[t][0][k];
#pragma unroll
        for (int w8 = 1; w8 < kWarps; ++w8) a = a + s_part[t][w8][k];
        s[k] = a;
      }
      const float4 co = s_co[t];
      float* out = inst_grads + perm[start + lo + t] * kTerms;
      out[0] = -(co.x * s[1] + co.y * s[2]);
      out[1] = -(co.z * s[2] + co.y * s[1]);
      out[2] = -0.5f * s[3];
      out[3] = -s[4];
      out[4] = -0.5f * s[5];
      out[5] = s[0] / co.w;
      out[6] = s[6];
      out[7] = s[7];
      out[8] = s[8];
    }
  }
}

__global__ void flat_raster_reduce_kernel(
    const float* __restrict__ inst_grads,     // (M, 9), presort order
    const int64_t* __restrict__ rank_start,   // (N + 1,)
    const int64_t* __restrict__ order,        // (N,) depth rank -> Gaussian id
    int n,
    float* __restrict__ grads)                // (N, 9)
{
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
  const int64_t e = rank_start[j + 1];
  for (int64_t i = rank_start[j]; i < e; ++i) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[k] = acc[k] + inst_grads[i * kTerms + k];
  }
  float* out = grads + order[j] * kTerms;
#pragma unroll
  for (int k = 0; k < kTerms; ++k) out[k] = acc[k];
}

}  // namespace

extern "C" int flat_raster_backward(
    void* tile_start, void* tile_end, void* point_list, void* perm,
    void* xy, void* conic_op, void* rgb,
    void* t_final, void* n_contrib, void* dc, void* bg,
    int width, int height, int tiles_x, int tiles_y,
    void* inst_grads, void* stream)
{
  if (tiles_x > 0 && tiles_y > 0) {
    dim3 grid(tiles_x, tiles_y);
    flat_raster_backward_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tile_start, (const int32_t*)tile_end, (const int32_t*)point_list,
        (const int64_t*)perm, (const float2*)xy, (const float4*)conic_op, (const float*)rgb,
        (const float*)t_final, (const int32_t*)n_contrib, (const float*)dc, (const float*)bg,
        width, height, tiles_x, (float*)inst_grads);
  }
  return (int)cudaGetLastError();
}

extern "C" int flat_raster_reduce(void* inst_grads, void* rank_start, void* order, int n,
                                  void* grads, void* stream)
{
  if (n > 0) {
    const int threads = 256;
    flat_raster_reduce_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        (const float*)inst_grads, (const int64_t*)rank_start, (const int64_t*)order, n,
        (float*)grads);
  }
  return (int)cudaGetLastError();
}
