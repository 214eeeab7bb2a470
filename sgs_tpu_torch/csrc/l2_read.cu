// The card's L2 read rate: a streaming read of a buffer that the L2 holds.
//
// Not the port of a TPU kernel: a probe whose rate the bounds take
// (sgs_tpu_torch/tools/l2_rate.py, tools/exp_bounds.py). Kernel H gathers
// 64-byte records by id from a table of a few MB, far past a block's shared
// memory, so its record reads are served by the L2, and its least time is
// those bytes over this rate.
//
// Each thread reads 16-byte quads i, i + S, i + 2S, ... (S the threads of
// the grid) with ld.global.cg, cached in the L2 and not in L1, four in
// flight, `passes` times over the buffer, and adds them up; one thread
// writes a sum only if it is an impossible value, so the reads are kept and
// nothing else touches memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kInFlight = 4;

__global__ void __launch_bounds__(kThreads)
l2_read_kernel(const float4* __restrict__ buf, int n4, int passes, float* __restrict__ sink)
{
  const int stride = gridDim.x * kThreads;
  float acc = 0.0f;
  for (int p = 0; p < passes; ++p) {
    int i = blockIdx.x * kThreads + threadIdx.x;
    for (; i + (kInFlight - 1) * stride < n4; i += kInFlight * stride) {
      float4 v[kInFlight];
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) v[j] = __ldcg(buf + i + j * stride);
#pragma unroll
      for (int j = 0; j < kInFlight; ++j) acc += (v[j].x + v[j].y) + (v[j].z + v[j].w);
    }
    for (; i < n4; i += stride) {
      const float4 v = __ldcg(buf + i);
      acc += (v.x + v.y) + (v.z + v.w);
    }
  }
  if (acc == -1.0f) sink[0] = acc;  // the buffer holds ones: never
}

}  // namespace

// buf: n4 float4s of ones; blocks: the grid (a few per SM).
extern "C" int l2_read_launch(void* buf, int n4, int passes, int blocks, void* sink, void* stream)
{
  if (n4 <= 0 || passes <= 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  l2_read_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((const float4*)buf, n4, passes,
                                                               (float*)sink);
  return (int)cudaGetLastError();
}
