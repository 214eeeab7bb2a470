// Raster forward (Kernel A): front-to-back alpha compositing of each 16x16
// tile's depth-ordered Gaussian list, one 256-thread block per tile, one
// thread per pixel.
//
// Replaces the TPU kernel sgs_tpu/ops/pallas/flat_raster.py::forward_flat
// (_fwd_kernel_body). The TPU version packs instances into a transposed
// (REC, slots) operand, walks 64-instance chunks with a Hillis-Steele
// cumprod and sums colours on the MXU; those are TPU layout devices and
// have no counterpart here. This is the classic per-tile CUDA design:
// the block stages batches of 256 instance records in shared memory by
// Gaussian id, then every thread walks them in order until its
// transmittance latch trips.
//
// Bound: at the flagship shapes the kernel is bound by operations (about
// 26 f32 operations per instance-pixel pair walked, exp counted as one)
// rather than by bytes (each instance record is read once per tile,
// 48 bytes, and each pixel writes 20 bytes). The design keeps the whole
// per-pixel state in registers and the records in shared memory, and
// the block leaves as soon as every pixel is saturated
// (__syncthreads_count). What it does about the time lost around the
// walk:
//   - each Gaussian is one 48-byte record (conic, opacity | mean, r, g |
//     b, pad; built by render/tiled.py::kernel_args), staged with three
//     16-byte cp.async copies into a double buffer: batch b + 1 is in
//     flight while batch b is walked, and the ids of batch b + 2 are
//     loaded a batch ahead, so the gather by id overlaps the walk;
//   - block b works on tile schedule[b], the tiles by list length longest
//     first (binning's order), so the longest lists start first instead
//     of trailing the grid. Each tile's arithmetic is the same in any
//     order, so no output bit depends on the schedule.
//
// Numerics follow the JAX kernel term by term (dx = mean - pixel, the
// factored quadratic, alpha = min(0.99, op * exp(power)) used only if
// power <= 0 and alpha >= 1/255, inclusion while T * (1 - alpha) stays
// >= 1e-4). The file is built with --fmad=false so each product and sum
// rounds as the plain PyTorch version's separate ops do.
//
// Outputs: color (3, H, W), t_final (H, W) and n_contrib (H, W). n_contrib
// follows the CUDA reference convention: the 1-based position, within the
// tile's list, of the last instance the pixel composited (0 if none). It
// is what the backward walk needs to start from.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kBlock = kTile * kTile;
constexpr int kRecVecs = 3;  // float4s per record
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kTransmittanceEps = 1e-4f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void stage_record(float4* dst, const float4* __restrict__ records, int g) {
  if (g >= 0) {
    const float4* src = records + (int64_t)g * kRecVecs;
#pragma unroll
    for (int k = 0; k < kRecVecs; ++k) cp_async16(dst + k, src + k);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kBlock)
flat_raster_forward_kernel(
    const int32_t* __restrict__ tile_start,   // (T,)
    const int32_t* __restrict__ tile_end,     // (T,)
    const int32_t* __restrict__ point_list,   // (M,) Gaussian ids, tile-sorted
    const int32_t* __restrict__ schedule,     // (T,) tile of each block
    const float4* __restrict__ records,       // (N, 3) float4 records
    int width, int height, int tiles_x,
    float* __restrict__ color,                // (3, H, W)
    float* __restrict__ t_final,              // (H, W)
    int32_t* __restrict__ n_contrib)          // (H, W)
{
  __shared__ float4 s_rec[2][kBlock][kRecVecs];

  const int tile = schedule[blockIdx.x];
  const int t = threadIdx.x;
  const int px = (tile % tiles_x) * kTile + (t % kTile);
  const int py = (tile / tiles_x) * kTile + (t / kTile);
  const bool inside = px < width && py < height;
  const float fx = (float)px;
  const float fy = (float)py;

  const int start = tile_start[tile];
  const int end = tile_end[tile];
  bool done = !inside;
  float T = 1.0f;
  float c0 = 0.0f, c1 = 0.0f, c2 = 0.0f;
  int walked = 0;
  int last = 0;

  // batch 0 in flight, the ids of batch 1 in a register
  stage_record(s_rec[0][t], records, start + t < end ? point_list[start + t] : -1);
  int g_next = start + kBlock + t < end ? point_list[start + kBlock + t] : -1;

  for (int base = start, buf = 0; base < end; base += kBlock, buf ^= 1) {
    // batch b + 1 into the other buffer (consumed at the end of the last
    // iteration), then the ids of batch b + 2
    stage_record(s_rec[buf ^ 1][t], records, g_next);
    const int i2 = base + 2 * kBlock + t;
    g_next = i2 < end ? point_list[i2] : -1;
    cp_async_wait<1>();  // this thread's copies of batch b have landed
    // the barrier publishes every thread's copies; the block leaves together
    if (__syncthreads_count(done) == kBlock) break;
    const int batch = min(kBlock, end - base);
    for (int j = 0; !done && j < batch; ++j) {
      ++walked;
      const float4 co = s_rec[buf][j][0];
      const float4 mc = s_rec[buf][j][1];
      const float dx = mc.x - fx;
      const float dy = mc.y - fy;
      const float power = (-0.5f * co.x * dx - co.y * dy) * dx + (-0.5f * co.z) * dy * dy;
      if (power > 0.0f) continue;
      const float alpha = fminf(kAlphaMax, co.w * expf(power));
      if (alpha < kAlphaMin) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < kTransmittanceEps) {
        done = true;
        continue;
      }
      const float w = T * alpha;
      c0 += mc.z * w;
      c1 += mc.w * w;
      c2 += s_rec[buf][j][2].x * w;
      T = test_t;
      last = walked;
    }
    __syncthreads();  // batch b is consumed before its buffer is refilled
  }
  cp_async_wait<0>();

  if (inside) {
    const int pix = py * width + px;
    const int plane = width * height;
    color[pix] = c0;
    color[plane + pix] = c1;
    color[2 * plane + pix] = c2;
    t_final[pix] = T;
    n_contrib[pix] = last;
  }
}

}  // namespace

extern "C" int flat_raster_forward(
    void* tile_start, void* tile_end, void* point_list, void* schedule, void* records,
    int width, int height, int tiles_x, int tiles_y,
    void* color, void* t_final, void* n_contrib, void* stream)
{
  if (tiles_x > 0 && tiles_y > 0) {
    flat_raster_forward_kernel<<<tiles_x * tiles_y, kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tile_start, (const int32_t*)tile_end, (const int32_t*)point_list,
        (const int32_t*)schedule, (const float4*)records, width, height, tiles_x,
        (float*)color, (float*)t_final, (int32_t*)n_contrib);
  }
  return (int)cudaGetLastError();
}
