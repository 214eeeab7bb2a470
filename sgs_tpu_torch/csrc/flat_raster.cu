// Raster forward: front-to-back alpha compositing of each 16x16 tile's
// depth-ordered Gaussian list, one 256-thread block per tile, one thread
// per pixel.
//
// Replaces the TPU kernel sgs_tpu/ops/pallas/flat_raster.py::forward_flat
// (_fwd_kernel_body). The TPU version packs instances into a transposed
// (REC, slots) operand, walks 64-instance chunks with a Hillis-Steele
// cumprod and sums colours on the MXU; those are TPU layout devices and
// have no counterpart here. This is the classic per-tile CUDA design:
// the block loads batches of 256 instance records (mean2d, conic,
// opacity, rgb) into shared memory by Gaussian id, then every thread
// walks them in order until its transmittance latch trips.
//
// Bound: at the flagship shapes the kernel is bound by operations (about
// 26 f32 operations per instance-pixel pair walked, exp counted as one)
// rather than by bytes (each instance record is read once per tile,
// 40 bytes, and each pixel writes 20 bytes). The design keeps the whole
// per-pixel state in registers and the records in shared memory, and
// the block leaves as soon as every pixel is saturated
// (__syncthreads_count).
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
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kTransmittanceEps = 1e-4f;

__global__ void __launch_bounds__(kBlock)
flat_raster_forward_kernel(
    const int32_t* __restrict__ tile_start,   // (T,)
    const int32_t* __restrict__ tile_end,     // (T,)
    const int32_t* __restrict__ point_list,   // (M,) Gaussian ids, tile-sorted
    const float2* __restrict__ xy,            // (N,) pixel-space means
    const float4* __restrict__ conic_op,      // (N,) conic a, b, c, opacity
    const float* __restrict__ rgb,            // (N, 3)
    int width, int height, int tiles_x,
    float* __restrict__ color,                // (3, H, W)
    float* __restrict__ t_final,              // (H, W)
    int32_t* __restrict__ n_contrib)          // (H, W)
{
  __shared__ float2 s_xy[kBlock];
  __shared__ float4 s_co[kBlock];
  __shared__ float s_rgb[3 * kBlock];

  const int tile = blockIdx.y * tiles_x + blockIdx.x;
  const int t = threadIdx.x;
  const int px = blockIdx.x * kTile + (t % kTile);
  const int py = blockIdx.y * kTile + (t / kTile);
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

  for (int base = start; base < end; base += kBlock) {
    // every thread takes part in the loads, so the block leaves together
    if (__syncthreads_count(done) == kBlock) break;
    const int i = base + t;
    if (i < end) {
      const int g = point_list[i];
      s_xy[t] = xy[g];
      s_co[t] = conic_op[g];
      s_rgb[3 * t + 0] = rgb[3 * g + 0];
      s_rgb[3 * t + 1] = rgb[3 * g + 1];
      s_rgb[3 * t + 2] = rgb[3 * g + 2];
    }
    __syncthreads();
    const int batch = min(kBlock, end - base);
    for (int j = 0; !done && j < batch; ++j) {
      ++walked;
      const float2 m = s_xy[j];
      const float4 co = s_co[j];
      const float dx = m.x - fx;
      const float dy = m.y - fy;
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
      c0 += s_rgb[3 * j + 0] * w;
      c1 += s_rgb[3 * j + 1] * w;
      c2 += s_rgb[3 * j + 2] * w;
      T = test_t;
      last = walked;
    }
  }

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
    void* tile_start, void* tile_end, void* point_list,
    void* xy, void* conic_op, void* rgb,
    int width, int height, int tiles_x, int tiles_y,
    void* color, void* t_final, void* n_contrib, void* stream)
{
  if (tiles_x > 0 && tiles_y > 0) {
    dim3 grid(tiles_x, tiles_y);
    flat_raster_forward_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
        (const int32_t*)tile_start, (const int32_t*)tile_end, (const int32_t*)point_list,
        (const float2*)xy, (const float4*)conic_op, (const float*)rgb,
        width, height, tiles_x,
        (float*)color, (float*)t_final, (int32_t*)n_contrib);
  }
  return (int)cudaGetLastError();
}
