// Gather experiments (Kernels H, I, J and K): the stripped kernels that
// measured how the packed rows of the flat rasterizer could be gathered.
//
// Replaces the TPU kernels of
//   H  scripts/exp_vmem_gather.py::kern: per grid step, the sum over 8 rows
//      of (128, 16) records gathered by id from a table held in VMEM;
//   I  scripts/exp_dma_gather.py::kern_a: per grid step, the sum over 8
//      rows of rec + rec, read from a pre-packed (padded) array;
//   J  scripts/exp_dma_gather.py::kern_b: the sum over every row of
//      rec + rec, each row's (128, 16) window DMA'd from the attribute
//      table at its start;
//   K  scripts/exp_gather_layout.py::ident: the identity copy.
// Python side, plain versions and launch counts: sgs_tpu_torch/ops/gather.py.
//
// What the TPU programs compute, kept here:
//   - H and I map every grid step's output to the same block and assign to
//     it, so the TPU returns only the last step's sum. Every step's gather
//     is still done: here each step is one block that writes its own
//     (128, 16) partial, and the wrapper returns them all;
//   - J carries one sum across the whole grid. The TPU runs the rows in
//     order on one core; here each block sums a contiguous range of
//     kRowsPerBlock rows in row order, and the last block to finish (an
//     integer ticket, no float atomics) adds the per-block partials in
//     block order. The plain version spells out that order, so the kernel
//     equals it bit for bit; it differs from the TPU's serial sum in the
//     last bits only;
//   - every sum starts from zero and adds in the order written below,
//     acc = acc + rec (H) or acc = acc + (rec + rec) (I, J), built with
//     --fmad=false (nothing here can contract, but the flag keeps the
//     rule of the other sources).
//
// Design. One record is 16 f32 = four 16-byte quads; a block of 512
// threads covers one (128, 16) window, thread t taking quad t % 4 of lane
// t / 4, so four neighbouring threads read one 64-byte record and a warp
// reads 512 contiguous bytes of a packed or DMA'd window.
//   H: the 8 ids of a thread are loaded first, then its 8 record quads by
//      16-byte __ldg loads, all in flight together. The table (6.4 MB at
//      the script's size) is far past the 227 KB of shared memory a block
//      can hold, so it is not staged: after its first touch it stays in
//      the 50 MB L2, the counterpart of the VMEM-resident table.
//   I: the same layout streaming the packed array, 8 loads in flight.
//   J: a ring of kStages windows in shared memory filled by cp.async
//      (16 bytes a thread, 8 KiB a window), kStages - 1 windows in flight
//      while the thread adds the oldest, the counterpart of the TPU's two
//      DMA slots. Each thread copies and reads only its own 16 bytes of a
//      window, so cp.async.wait_group alone orders them; no barrier.
//   K: a grid-stride copy with 16-byte loads and stores. A row-major
//      source is a flat copy. A field-major source (rows, rec) with
//      strides (1, rows), the counterpart of XLA's compact {0,1} layout,
//      is transposed through shared memory, 256 rows at a time.
//
// Bound: bytes, all four. H reads the ids and the table once and writes
// the per-step partials (31 MB at the script's size); I reads the packed
// array and writes the partials (149 MB); J reads the rows its windows
// cover once (65 MB); K reads and writes the table (264 MB for 16 lanes).
// Their f32 adds (1 or 2 per gathered element) are far below the bytes.
// Out-of-range ids and starts are clamped into the table (JAX's rule for
// gathers; a window never leaves the attribute array).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;                // lanes of a window (the scripts' CHUNK)
constexpr int kKRows = 8;                  // rows per grid step (KROWS)
constexpr int kRec = 16;                   // f32 per record (REC)
constexpr int kQuads = kRec / 4;           // 16-byte quads per record
constexpr int kThreads = kChunk * kQuads;  // one thread per quad of a window
constexpr int kStages = 4;                 // J's ring of windows in shared memory
constexpr int kRowsPerBlock = 128;         // J's rows per block (ops/gather.py J_ROWS_PER_BLOCK)
constexpr int kCopyThreads = 256;
constexpr int kTileRows = 256;             // K's rows per shared-memory tile
constexpr int kTilePitch = kTileRows + 4;  // floats per field in the tile

__device__ __forceinline__ float4 add(float4 a, float4 b)
{
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 twice(float4 a) { return add(a, a); }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// The "memory" clobbers keep the compiler from moving a shared-memory read
// of the ring across the copy that refills it or the wait that lands it.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem)
{
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// H: block `step` sums the records of ids[step * 1024 + j * 128 + lane],
// j = 0 .. 7, in j order.
__global__ void __launch_bounds__(kThreads)
vmem_gather_kernel(const float4* __restrict__ table, int n_table, const int32_t* __restrict__ ids,
                   float4* __restrict__ partials)
{
  const int step = blockIdx.x;
  const int lane = threadIdx.x / kQuads, q = threadIdx.x % kQuads;
  const int32_t* sid = ids + (size_t)step * kKRows * kChunk + lane;
  int id[kKRows];
#pragma unroll
  for (int j = 0; j < kKRows; ++j) id[j] = clampi(__ldg(sid + j * kChunk), 0, n_table - 1);
  float4 rec[kKRows];
#pragma unroll
  for (int j = 0; j < kKRows; ++j) rec[j] = __ldg(table + (size_t)id[j] * kQuads + q);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < kKRows; ++j) acc = add(acc, rec[j]);
  partials[(size_t)step * kThreads + threadIdx.x] = acc;
}

// I: block `step` sums rec + rec over packed rows step * 8 + j, j = 0 .. 7.
__global__ void __launch_bounds__(kThreads)
packed_sum_kernel(const float4* __restrict__ packed, float4* __restrict__ partials)
{
  const size_t base = (size_t)blockIdx.x * kKRows * kThreads + threadIdx.x;
  float4 rec[kKRows];
#pragma unroll
  for (int j = 0; j < kKRows; ++j) rec[j] = __ldcs(packed + base + (size_t)j * kThreads);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int j = 0; j < kKRows; ++j) acc = add(acc, twice(rec[j]));
  partials[(size_t)blockIdx.x * kThreads + threadIdx.x] = acc;
}

// J: window i of the block's rows into `slot` (this thread's 16 bytes).
// One commit group per window, empty past the block's n rows, so that
// wait_group<kStages - 1> always means "window i has landed".
__device__ __forceinline__ void issue_window(float4* slot, const float4* __restrict__ attr,
                                             const int32_t* __restrict__ starts, int r0, int i, int n,
                                             int max_start, int t)
{
  if (i < n) {
    const int s = clampi(__ldg(starts + r0 + i), 0, max_start);
    cp_async16(slot, attr + (size_t)s * kQuads + t);
  }
  cp_async_commit();
}

// J: block b sums rec + rec over the windows attr[starts[r] : starts[r] +
// 128] of rows r = b * kRowsPerBlock .. in row order; the last block to
// finish adds the block partials in block order. Calls on two streams at
// once must not share `ticket`: the last block resets it to 0.
__global__ void __launch_bounds__(kThreads)
dma_gather_kernel(const float4* __restrict__ attr, int max_start, const int32_t* __restrict__ starts,
                  int rows, float4* __restrict__ partials, unsigned* __restrict__ ticket,
                  float4* __restrict__ out)
{
  __shared__ float4 ring[kStages][kThreads];
  __shared__ bool last;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * kRowsPerBlock;
  const int n = min(kRowsPerBlock, rows - r0);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue_window(ring[i % kStages] + t, attr, starts, r0, i, n, max_start, t);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = 0; i < n; ++i) {
    const int k = i + kStages - 1;
    issue_window(ring[k % kStages] + t, attr, starts, r0, k, n, max_start, t);
    cp_async_wait<kStages - 1>();
    acc = add(acc, twice(ring[i % kStages][t]));
  }
  partials[(size_t)blockIdx.x * kThreads + t] = acc;
  __threadfence();
  __syncthreads();
  if (t == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float4 total = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
  for (int b = 0; b < (int)gridDim.x; ++b) total = add(total, __ldcg(partials + (size_t)b * kThreads + t));
  out[t] = total;
  if (t == 0) *ticket = 0u;
}

// K, row-major source: a flat copy of n4 quads.
__global__ void __launch_bounds__(kCopyThreads)
copy_kernel(const float4* __restrict__ x, size_t n4, float4* __restrict__ out)
{
  for (size_t i = (size_t)blockIdx.x * kCopyThreads + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * kCopyThreads)
    out[i] = __ldcs(x + i);
}

// K, field-major source x[f * rows + i] (f < REC) to row-major out[i * REC
// + f], through shared memory in tiles of kTileRows rows: each field's run
// of the tile is read with coalesced 16-byte loads, and the tile written
// as one contiguous run of 16-byte stores. The tile pitch (4 mod 32
// floats) keeps the column reads to at most 2-way bank conflicts. Rows
// not a multiple of 4 take a scalar copy.
template <int REC>
__global__ void __launch_bounds__(kCopyThreads)
field_major_copy_kernel(const float* __restrict__ x, int rows, float* __restrict__ out)
{
  __shared__ __align__(16) float tile[REC * kTilePitch];
  const int t = threadIdx.x;
  if (rows % 4 != 0) {
    for (size_t i = (size_t)blockIdx.x * kCopyThreads + t; i < (size_t)rows;
         i += (size_t)gridDim.x * kCopyThreads)
#pragma unroll
      for (int f = 0; f < REC; ++f) out[i * REC + f] = x[(size_t)f * rows + i];
    return;
  }
  const int tiles = (rows + kTileRows - 1) / kTileRows;
  for (int b = blockIdx.x; b < tiles; b += gridDim.x) {
    const int r0 = b * kTileRows;
    const int n = min(kTileRows, rows - r0);  // a multiple of 4
#pragma unroll
    for (int k = 0; k < REC / 4; ++k) {
      const int l = t + k * kCopyThreads;  // quad l of the tile: field f, rows 4g .. 4g + 3
      const int f = l / (kTileRows / 4), g = l % (kTileRows / 4);
      if (4 * g < n)
        *reinterpret_cast<float4*>(tile + f * kTilePitch + 4 * g) =
            __ldcs(reinterpret_cast<const float4*>(x + (size_t)f * rows + r0) + g);
    }
    __syncthreads();
    float4* o = reinterpret_cast<float4*>(out + (size_t)r0 * REC);
#pragma unroll
    for (int k = 0; k < REC / 4; ++k) {
      const int l = t + k * kCopyThreads;  // output quad l: row r, fields f .. f + 3
      const int r = l / (REC / 4), f = (l % (REC / 4)) * 4;
      if (r < n)
        o[l] = make_float4(tile[f * kTilePitch + r], tile[(f + 1) * kTilePitch + r],
                           tile[(f + 2) * kTilePitch + r], tile[(f + 3) * kTilePitch + r]);
    }
    __syncthreads();
  }
}

int copy_blocks(size_t work)
{
  const size_t blocks = (work + kCopyThreads - 1) / kCopyThreads;
  return (int)(blocks < 132 * 16 ? blocks : 132 * 16);
}

}  // namespace

extern "C" int gather_vmem_launch(void* table, int n_table, void* ids, int steps, void* partials,
                                  void* stream)
{
  if (steps <= 0 || n_table <= 0) return (int)cudaErrorInvalidValue;
  vmem_gather_kernel<<<steps, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)table, n_table, (const int32_t*)ids, (float4*)partials);
  return (int)cudaGetLastError();
}

extern "C" int gather_packed_launch(void* packed, int steps, void* partials, void* stream)
{
  if (steps <= 0) return (int)cudaErrorInvalidValue;
  packed_sum_kernel<<<steps, kThreads, 0, (cudaStream_t)stream>>>((const float4*)packed,
                                                                  (float4*)partials);
  return (int)cudaGetLastError();
}

extern "C" int gather_dma_launch(void* attr, int n_attr, void* starts, int rows, void* partials,
                                 void* ticket, void* out, void* stream)
{
  if (rows <= 0 || n_attr < kChunk) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  dma_gather_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)attr, n_attr - kChunk, (const int32_t*)starts, rows, (float4*)partials,
      (unsigned*)ticket, (float4*)out);
  return (int)cudaGetLastError();
}

extern "C" int gather_identity_launch(void* x, int rows, int rec, int field_major, void* out,
                                      void* stream)
{
  if (rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!field_major) {
    const size_t n4 = (size_t)rows * rec / 4;
    copy_kernel<<<copy_blocks(n4), kCopyThreads, 0, s>>>((const float4*)x, n4, (float4*)out);
  } else {
    const size_t work = rows % 4 == 0 ? (size_t)(rows + kTileRows - 1) / kTileRows * kCopyThreads
                                      : (size_t)rows;
    if (rec == 16)
      field_major_copy_kernel<16><<<copy_blocks(work), kCopyThreads, 0, s>>>((const float*)x, rows,
                                                                            (float*)out);
    else if (rec == 8)
      field_major_copy_kernel<8><<<copy_blocks(work), kCopyThreads, 0, s>>>((const float*)x, rows,
                                                                           (float*)out);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
