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
// Launch 1 (flat_raster_backward_kernel, "the walk"): one 256-thread block
// per 16x16 tile, one thread per pixel, as in the forward kernel; block b
// works on tile schedule[b] (longest list first). The block walks its
// tile's depth-ordered list back to front, from the largest n_contrib of
// its pixels down to 0, in shared-memory batches of kBatch records. Each
// pixel starts from its forward state: T = t_final and the suffix
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
// the tile's 256 pixels in a fixed order (the xor butterfly inside each
// warp, then the 8 warps in order), and the block turns the sums into the
// 9 gradient components [d mean x, d mean y, d conic a, b, c, d opacity,
// d r, g, b] and writes them at the instance's depth-rank-major
// ("presort") position perm[i]. Instances past the tile's largest
// n_contrib get zeros.
//
// Launch 2 (flat_raster_reduce_kernel, "the reduction"): one warp per depth
// rank. In presort order every Gaussian's instances are contiguous; lane l
// sums elements l, l + 32, ... of the run in order, so neighbouring lanes
// read neighbouring rows, and the 32 lane sums meet in the xor-butterfly
// order. The order depends only on the run's length; an empty run costs
// one write of zeros. No float atomics anywhere: two runs give the same
// bits.
//
// Bound: like the forward, the walk is bound by operations (about 50 f32
// operations per instance-pixel pair it walks, counting the recomputed
// forward terms and the 9 reduction adds) rather than bytes (48 bytes of
// record per instance and tile, 20 bytes per pixel, 36 bytes written per
// instance); the reduction is bound by bytes (36 read per instance, 36
// written per Gaussian). What the design does against the time lost in
// the walk:
//   - the 9 warp sums are a reduce-scatter: 12 shuffles instead of 9 x 5,
//     each lane ending with one term's sum. The pairs added are the
//     butterfly's, and f32 addition commutes, so the bits are the
//     butterfly's;
//   - a warp in which no pixel included the instance (__any_sync) skips
//     the shuffles and writes +0 partials, which is what the butterfly of
//     +0 terms gives;
//   - 64 records are staged per pair of barriers (32 before), and the
//     combine of the 8 warps' partials and the 9 stores per instance are
//     spread over all 256 threads (one warp before);
//   - the longest lists start first (schedule).
// `python -m sgs_tpu_torch.tools.walk_ablation` times the walk with each
// of these undone, and with a candidate that was measured and left out:
// skipping the pair math in warps whose pixels all lie past the instance
// cost more in branches than it saved.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kWarps = kBlock / 32;
constexpr int kBatch = 64;
constexpr int kTerms = 9;
constexpr int kRecVecs = 3;  // float4s per record
constexpr unsigned kFull = 0xffffffffu;
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = (float)(1.0 / 255.0);

// The term whose 32-lane sum `reduce_scatter9` leaves in lane 2i and
// 2i + 1 (-1: none). Lanes 0-15 end with terms 0-4, lanes 16-31 with 5-8.
__constant__ int8_t kOwner[16] = {0, 1, 2, -1, 3, 4, -1, -1, 5, 6, 7, -1, 8, -1, -1, -1};

// One step of the reduce-scatter: the lane keeps half of its n slots (the
// upper half when `upper`), sends the other half to the lane `off` away
// and adds what it receives. Slots past n hold +0.
template <int kIn, int kOut>
__device__ __forceinline__ void scatter_step(const float (&in)[kIn], float (&out)[kOut], bool upper,
                                             int off) {
#pragma unroll
  for (int i = 0; i < kOut; ++i) {
    const float lo = in[i];
    const float hi = i + kOut < kIn ? in[i + kOut] : 0.0f;
    const float other = __shfl_xor_sync(kFull, upper ? lo : hi, off);
    out[i] = (upper ? hi : lo) + other;
  }
}

// The 32-lane sums of 9 values in 12 shuffles; lane l returns the sum of
// term kOwner[l >> 1]. Each sum pairs lanes as the xor butterfly does
// (l with l ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1), so it has the butterfly's bits.
__device__ __forceinline__ float reduce_scatter9(const float (&v)[kTerms], int lane) {
  float a[5], b[3], c[2], d[1];
  scatter_step<9, 5>(v, a, lane & 16, 16);
  scatter_step<5, 3>(a, b, lane & 8, 8);
  scatter_step<3, 2>(b, c, lane & 4, 4);
  scatter_step<2, 1>(c, d, lane & 2, 2);
  return d[0] + __shfl_xor_sync(kFull, d[0], 1);
}

// The part of a pixel's step that does not depend on T and S: Kernel A's
// power and alpha, the include test (`reach`: the position is below the
// pixel's n_contrib) and dC . colour.
struct Front {
  float dx, dy, q, alpha, dcc;
  bool included;
};

__device__ __forceinline__ Front front(const float4 (&rec)[kRecVecs], float fx, float fy, float d0,
                                       float d1, float d2, bool reach) {
  const float4 co = rec[0];
  const float4 mc = rec[1];
  Front f;
  f.dx = mc.x - fx;
  f.dy = mc.y - fy;
  const float power = (-0.5f * co.x * f.dx - co.y * f.dy) * f.dx + (-0.5f * co.z) * f.dy * f.dy;
  f.q = co.w * expf(power);
  f.alpha = fminf(kAlphaMax, f.q);
  f.included = reach && power <= 0.0f && f.alpha >= kAlphaMin;
  f.dcc = d0 * mc.z + d1 * mc.w + d2 * rec[2].x;
  return f;
}

__global__ void __launch_bounds__(kBlock)
flat_raster_backward_kernel(
    const int32_t* __restrict__ tile_start,   // (T,)
    const int32_t* __restrict__ tile_end,     // (T,)
    const int32_t* __restrict__ point_list,   // (M,) Gaussian ids, tile-sorted
    const int32_t* __restrict__ schedule,     // (T,) tile of each block
    const int64_t* __restrict__ perm,         // (M,) presort position of each instance
    const float4* __restrict__ records,       // (N, 3) float4 records
    const float* __restrict__ t_final,        // (H, W)
    const int32_t* __restrict__ n_contrib,    // (H, W)
    const float* __restrict__ dc,             // (3, H, W) image cotangent
    const float* __restrict__ bg,             // (3,)
    int width, int height, int tiles_x,
    float* __restrict__ inst_grads)           // (M, 9), presort order
{
  __shared__ float4 s_rec[kBatch][kRecVecs];
  __shared__ float s_part[kBatch][kWarps][kTerms];
  __shared__ int s_max;

  const int tile = schedule[blockIdx.x];
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int warp = t / 32;
  const int px = (tile % tiles_x) * kTile + (t % kTile);
  const int py = (tile / tiles_x) * kTile + (t / kTile);
  const bool inside = px < width && py < height;
  const float fx = (float)px;
  const float fy = (float)py;
  const int owner = kOwner[lane >> 1];
  const bool writes = owner >= 0 && (lane & 1) == 0;

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
  const int warp_last = __reduce_max_sync(kFull, last);

  if (t == 0) s_max = 0;
  __syncthreads();
  if (lane == 0 && warp_last > 0) atomicMax(&s_max, warp_last);
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
    if (t < batch * kRecVecs) {
      const int j = t / kRecVecs;
      const int g = point_list[start + lo + j];
      s_rec[j][t % kRecVecs] = records[(int64_t)g * kRecVecs + t % kRecVecs];
    }
    __syncthreads();
    for (int j = batch - 1; j >= 0; --j) {
      const int pos = lo + j;  // 0-based position in the tile's list
      float v[kTerms];
#pragma unroll
      for (int k = 0; k < kTerms; ++k) v[k] = 0.0f;
      bool included = false;
      if (pos < last) {
        const float4 co = s_rec[j][0];
        const float4 mc = s_rec[j][1];
        const float dx = mc.x - fx;
        const float dy = mc.y - fy;
        const float power = (-0.5f * co.x * dx - co.y * dy) * dx + (-0.5f * co.z) * dy * dy;
        const float q = co.w * expf(power);
        const float alpha = fminf(kAlphaMax, q);
        if (power <= 0.0f && alpha >= kAlphaMin) {
          included = true;
          const float u = 1.0f - alpha;
          const float t_i = T / u;
          const float dcc = d0 * mc.z + d1 * mc.w + d2 * s_rec[j][2].x;
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
      float sum = 0.0f;
      if (__any_sync(kFull, included)) sum = reduce_scatter9(v, lane);
      if (writes) s_part[j][warp][owner] = sum;
    }
    __syncthreads();
    // combine: thread per (instance, gradient component)
    for (int task = t; task < batch * kTerms; task += kBlock) {
      const int j = task / kTerms;
      const int k = task % kTerms;
      auto total = [&](int q) {
        float a = s_part[j][0][q];
#pragma unroll
        for (int w8 = 1; w8 < kWarps; ++w8) a = a + s_part[j][w8][q];
        return a;
      };
      const float4 co = s_rec[j][0];
      float r;
      switch (k) {
        case 0: r = -(co.x * total(1) + co.y * total(2)); break;
        case 1: r = -(co.z * total(2) + co.y * total(1)); break;
        case 2: r = -0.5f * total(3); break;
        case 3: r = -total(4); break;
        case 4: r = -0.5f * total(5); break;
        case 5: r = total(0) / co.w; break;
        default: r = total(k); break;
      }
      inst_grads[perm[start + lo + j] * kTerms + k] = r;
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
  const int j = (int)(((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / 32);
  const int lane = threadIdx.x % 32;
  if (j >= n) return;  // the whole warp
  const int64_t b = rank_start[j];
  const int64_t e = rank_start[j + 1];
  float* out = grads + order[j] * kTerms;
  if (e - b <= 1) {
    // the butterfly adds only +0 to lane 0's 0 + x
    if (lane < kTerms) out[lane] = e > b ? __fadd_rn(0.0f, inst_grads[b * kTerms + lane]) : 0.0f;
    return;
  }
  float acc[kTerms];
#pragma unroll
  for (int k = 0; k < kTerms; ++k) acc[k] = 0.0f;
  for (int64_t i = b + lane; i < e; i += 32) {
#pragma unroll
    for (int k = 0; k < kTerms; ++k) acc[k] = acc[k] + inst_grads[i * kTerms + k];
  }
  const float sum = reduce_scatter9(acc, lane);
  const int owner = kOwner[lane >> 1];
  if (owner >= 0 && (lane & 1) == 0) out[owner] = sum;
}

}  // namespace

extern "C" int flat_raster_backward(
    void* tile_start, void* tile_end, void* point_list, void* schedule, void* perm, void* records,
    void* t_final, void* n_contrib, void* dc, void* bg,
    int width, int height, int tiles_x, int tiles_y,
    void* inst_grads, void* stream)
{
  if (tiles_x > 0 && tiles_y > 0) {
    flat_raster_backward_kernel<<<tiles_x * tiles_y, kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tile_start, (const int32_t*)tile_end, (const int32_t*)point_list,
        (const int32_t*)schedule, (const int64_t*)perm, (const float4*)records,
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
    const int64_t blocks = ((int64_t)n * 32 + threads - 1) / threads;
    flat_raster_reduce_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)inst_grads, (const int64_t*)rank_start, (const int64_t*)order, n,
        (float*)grads);
  }
  return (int)cudaGetLastError();
}
