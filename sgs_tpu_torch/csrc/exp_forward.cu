// Forward-raster experiments (Kernels E, F and G): Kernel A's function on
// chunk-padded rows of 64 instances, written row by row, in the variants
// that the TPU experiments explored.
//
// Replaces the TPU kernels of scripts/exp_fwd.py::make_variant (E: modes
// hs, mxu, nocp), scripts/exp_fwd2.py::make_ablation (F: empty, outonly,
// alpha) and scripts/exp_transposed.py::make_transposed (G: hs, mxu on
// instance-major rows). Python side, plain versions and the definitions of
// what the TPU leaves open: sgs_tpu_torch/ops/exp_forward.py.
//
// Design: one 256-thread block per tile, one thread per pixel, blocks
// taking the tiles longest list first (`schedule`). The TPU grid runs in
// order on one core and carries the per-pixel state in scratch from row to
// row; here a block walks its tile's rows in order with the state in
// registers, and one more block writes the rows past the last tile's
// (which belong to no tile) with the initial state. The block stages
// `kKRows` rows of records into shared memory with 16-byte loads (of a
// field-major row only the fields the mode reads, 1.5 KiB for alpha and
// 2.25 KiB for the scans; an instance-major row whole, 4 KiB), then for
// each row:
//   - votes whether any pixel still has t_run >= 1e-4 (__syncthreads_or);
//     a row with none is skipped, its state still written;
//   - evaluates alpha for all 64 instances into registers (the JAX
//     expression term by term, built with --fmad=false);
//   - hs: the Hillis-Steele products cp[k] *= cp[k - s], s = 1, 2, ..., 32,
//     exactly the TPU kernel's products, in registers;
//     mxu: z = log(max(1 - a, 1e-30)) goes to shared memory, each warp
//     forms the inclusive sums of its 32 pixels' rows, z @ tri, with
//     mma.sync m16n8k8 TF32 on the tensor cores (z split into a TF32 high
//     and low part, so the sum keeps about f32 precision; tri is exact in
//     TF32, so the third product of 3xTF32 is zero and left out), in
//     place, last column block first; cp = exp(zc), cp_prev = exp(zc - z);
//     nocp: cp = cp_prev = 1 - a;
//   - sums the colours over the 64 instances by a halving tree (v[i] +
//     v[i + h], h = 32 .. 1), the order the plain version spells out;
//   - writes the state: pixel-major (256, 8) per row for E and F (two
//     16-byte stores per thread), pixels-minor (8, 256) for G (eight
//     coalesced 4-byte stores).
//
// Bound: operations at the 1080p scene (about 42 f32 operations per
// instance-pixel pair walked for E and G, 18 for F's alpha), then bytes:
// each row reads 1.5 to 4 KiB of records and writes 8 KiB of state, and
// the state is most of what these kernels move. This first version keeps all 64
// alphas and products of a row in registers (150 to 250 a thread, one
// block per SM); every array index is a compile-time constant, or the
// arrays would go to local memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kChunk = 64;
constexpr int kRec = 16;
constexpr int kRowFloats = kChunk * kRec;
constexpr int kState = 8;
constexpr int kZStride = kChunk + 4;  // padded z rows: fragment loads hit 32 banks
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kEps = 1e-4f;

enum Mode { kHs = 0, kMxu = 1, kNocp = 2, kEmpty = 3, kOutOnly = 4, kAlpha = 5 };

struct Rec {
  float mx, my, ca, cb, cc, op;
};

// Field f of instance k of a staged row: field-major (E, F) is
// row[f * 64 + k], instance-major (G) row[k * 16 + f], read as float4s.
template <bool kFieldMajor>
__device__ __forceinline__ Rec load_rec(const float* row, int k) {
  if constexpr (kFieldMajor) {
    return {row[k], row[kChunk + k], row[2 * kChunk + k], row[3 * kChunk + k],
            row[4 * kChunk + k], row[5 * kChunk + k]};
  } else {
    const float4 q0 = reinterpret_cast<const float4*>(row + k * kRec)[0];
    const float4 q1 = reinterpret_cast<const float4*>(row + k * kRec)[1];
    return {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y};
  }
}

template <bool kFieldMajor>
__device__ __forceinline__ float load_rgb(const float* row, int k, int c) {
  return kFieldMajor ? row[(6 + c) * kChunk + k] : row[k * kRec + 6 + c];
}

__device__ __forceinline__ float alpha_of(const Rec& r, float fx, float fy) {
  const float dx = r.mx - fx;
  const float dy = r.my - fy;
  const float power = -0.5f * (r.ca * dx * dx + r.cc * dy * dy) - r.cb * dx * dy;
  const float alpha = fminf(kAlphaMax, r.op * expf(power));
  return (power <= 0.0f && alpha >= kAlphaMin) ? alpha : 0.0f;
}

// One level of each tree, with its stride a template constant so that
// every index is known at compile time and the arrays stay in registers.
template <int kH>
__device__ __forceinline__ void tree_level(float (&v)[kChunk]) {
#pragma unroll
  for (int i = 0; i < kH; ++i) v[i] = v[i] + v[i + kH];
}

__device__ __forceinline__ float tree_sum(float (&v)[kChunk]) {
  tree_level<32>(v);
  tree_level<16>(v);
  tree_level<8>(v);
  tree_level<4>(v);
  tree_level<2>(v);
  tree_level<1>(v);
  return v[0];
}

// One Hillis-Steele step: cp[k] *= cp[k - s] for k >= s, top down, so
// each product reads the level's old cp[k - s].
template <int kS>
__device__ __forceinline__ void scan_level(float (&cp)[kChunk]) {
#pragma unroll
  for (int k = kChunk - 1; k >= kS; --k) cp[k] = cp[k] * cp[k - kS];
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The inclusive sums along each of a warp's 32 rows of z (zb, stride
// kZStride), in place: zc = z @ tri with tri[k][n] = (k <= n). Column block
// nn needs z's columns 0 .. 8 nn + 7 and is written over columns 8 nn ..
// 8 nn + 7, so going from the last block to the first reads only columns
// not yet written.
__device__ __forceinline__ void warp_cumsum(float* zb, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll 1
  for (int nn = kChunk / 8 - 1; nn >= 0; --nn) {
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll 1
    for (int kk = 0; kk <= nn; ++kk) {
      const uint32_t one = 0x3f800000u;  // 1.0f, exact in TF32
      const uint32_t b0 = (kk * 8 + t <= nn * 8 + g) ? one : 0u;
      const uint32_t b1 = (kk * 8 + t + 4 <= nn * 8 + g) ? one : 0u;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* zr = zb + mi * 16 * kZStride + kk * 8;
        const float x[4] = {zr[g * kZStride + t], zr[(g + 8) * kZStride + t],
                            zr[g * kZStride + t + 4], zr[(g + 8) * kZStride + t + 4]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          hi[i] = to_tf32(x[i]);
          lo[i] = to_tf32(x[i] - __uint_as_float(hi[i]));
        }
        mma_tf32(acc[mi], lo[0], lo[1], lo[2], lo[3], b0, b1);
        mma_tf32(acc[mi], hi[0], hi[1], hi[2], hi[3], b0, b1);
      }
    }
    __syncwarp();
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float* zr = zb + mi * 16 * kZStride + nn * 8 + 2 * t;
      zr[g * kZStride] = acc[mi][0];
      zr[g * kZStride + 1] = acc[mi][1];
      zr[(g + 8) * kZStride] = acc[mi][2];
      zr[(g + 8) * kZStride + 1] = acc[mi][3];
    }
    __syncwarp();
  }
}

// One row of E or G for pixel p: st is [r, g, b, t_run, t_final, last, 0, 0].
template <int kMode, bool kFieldMajor>
__device__ __forceinline__ void composite_row(const float* row, int r, int p, float fx, float fy,
                                              float (&st)[kState], float* s_z) {
  float a[kChunk], cp[kChunk];
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    a[k] = alpha_of(load_rec<kFieldMajor>(row, k), fx, fy);
    cp[k] = 1.0f - a[k];
  }
  const float t_row = st[3];
  if constexpr (kMode == kHs) {
    scan_level<1>(cp);
    scan_level<2>(cp);
    scan_level<4>(cp);
    scan_level<8>(cp);
    scan_level<16>(cp);
    scan_level<32>(cp);
  }
  float* zrow = s_z + p * kZStride;
  if constexpr (kMode == kMxu) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      cp[k] = logf(fmaxf(cp[k], 1e-30f));  // z, kept for cp_prev
      zrow[k] = cp[k];
    }
    __syncwarp();
    warp_cumsum(s_z + (p & ~31) * kZStride, p & 31);
  }
  float tf = 1.0f, last = 0.0f, t_run = t_row;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    float cpk, cppk;
    if constexpr (kMode == kMxu) {
      const float zc = zrow[k];
      cpk = expf(zc);
      cppk = expf(zc - cp[k]);
    } else if constexpr (kMode == kHs) {
      cpk = cp[k];
      cppk = k > 0 ? cp[k - 1] : 1.0f;
    } else {
      cpk = cp[k];
      cppk = cp[k];
    }
    const float s = t_row * cpk;
    const bool include = s >= kEps && a[k] > 0.0f;
    a[k] = include ? t_row * cppk * a[k] : 0.0f;  // the weight
    if (include) {
      tf = fminf(tf, s);
      last = fmaxf(last, ((float)(r * kChunk) + (float)k) + 1.0f);
    }
    if (k == kChunk - 1) t_run = s;
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) cp[k] = a[k] * load_rgb<kFieldMajor>(row, k, c);
    st[c] = st[c] + tree_sum(cp);
  }
  st[3] = t_run;
  st[4] = fminf(st[4], tf);
  st[5] = fmaxf(st[5], last);
}

template <bool kFieldMajor, int kOutCols>
__device__ __forceinline__ void write_state(float* __restrict__ out, int r, int p,
                                            const float (&st)[kState]) {
  if constexpr (!kFieldMajor) {  // G: (rows, 8, 256)
#pragma unroll
    for (int c = 0; c < kState; ++c) out[((int64_t)r * kState + c) * kPix + p] = st[c];
  } else if constexpr (kOutCols == kState) {
    float4* o = reinterpret_cast<float4*>(out + ((int64_t)r * kPix + p) * kState);
    o[0] = make_float4(st[0], st[1], st[2], st[3]);
    o[1] = make_float4(st[4], st[5], st[6], st[7]);
  } else {
    out[(int64_t)r * kPix + p] = st[0];
  }
}

template <int kMode, bool kFieldMajor, int kKRows, int kOutCols>
__global__ void __launch_bounds__(kPix, 1)
exp_forward_kernel(const float* __restrict__ packed,  // (rows, 1024) records
                   const int32_t* __restrict__ crs,   // (T,) first row of each tile
                   const int32_t* __restrict__ nch,   // (T,) rows of each tile
                   const int32_t* __restrict__ schedule,  // (T,) tile of each block
                   int num_tiles, int tiles_x, int max_rows,
                   float* __restrict__ out)
{
  if constexpr (kMode == kEmpty) return;
  extern __shared__ float4 smem4[];
  float* s_rec = reinterpret_cast<float*>(smem4);
  float* s_z = s_rec + kKRows * kRowFloats;
  const int p = threadIdx.x;
  const bool zero_init = kMode == kOutOnly || kMode == kAlpha;
  // float4s staged of each row: field-major rows hold each field's 64
  // values together, so only the fields the mode reads are loaded (x, y,
  // conic, opacity for alpha, and the colour for the scans);
  // instance-major rows (G) are staged whole.
  constexpr int kFields = kMode == kAlpha ? 6 : 9;
  constexpr int kStage4 = kFieldMajor ? kFields * kChunk / 4 : kRowFloats / 4;
  float st[kState];
#pragma unroll
  for (int c = 0; c < kState; ++c) st[c] = (!zero_init && (c == 3 || c == 4)) ? 1.0f : 0.0f;

  if (blockIdx.x == num_tiles) {  // rows past the last tile's
    for (int r = crs[num_tiles - 1] + nch[num_tiles - 1]; r < max_rows; ++r)
      write_state<kFieldMajor, kOutCols>(out, r, p, st);
    return;
  }
  const int tile = schedule[blockIdx.x];
  const int r0 = crs[tile];
  const int n = nch[tile];
  const float fx = (float)((tile % tiles_x) * kTile) + (float)(p % kTile);
  const float fy = (float)((tile / tiles_x) * kTile) + (float)(p / kTile);

  for (int base = 0; base < n; base += kKRows) {
    const int cnt = min(kKRows, n - base);
    if constexpr (kMode != kOutOnly) {
      __syncthreads();  // the rows staged before are consumed
      const float4* src = reinterpret_cast<const float4*>(packed + (int64_t)(r0 + base) * kRowFloats);
      for (int i = p; i < cnt * kStage4; i += kPix) {
        const int j = i / kStage4;  // float4 i - j * kStage4 of the fill's row j
        const int at = j * (kRowFloats / 4) + i - j * kStage4;
        smem4[at] = src[at];
      }
      __syncthreads();
    }
    for (int j = 0; j < cnt; ++j) {
      const int r = r0 + base + j;
      const float* row = s_rec + j * kRowFloats;
      if constexpr (kMode == kAlpha) {
        float v[kChunk];
#pragma unroll
        for (int k = 0; k < kChunk; ++k) v[k] = alpha_of(load_rec<true>(row, k), fx, fy);
        st[0] = st[0] + tree_sum(v);
      } else if constexpr (kMode != kOutOnly && kMode != kEmpty) {
        if (__syncthreads_or(st[3] >= kEps))
          composite_row<kMode, kFieldMajor>(row, r, p, fx, fy, st, s_z);
      }
      write_state<kFieldMajor, kOutCols>(out, r, p, st);
    }
  }
}

template <int kMode, bool kFieldMajor, int kKRows, int kOutCols>
int launch(const float* packed, const int32_t* crs, const int32_t* nch, const int32_t* schedule,
           int num_tiles, int tiles_x, int max_rows, float* out, cudaStream_t stream) {
  constexpr bool kStages = kMode != kEmpty && kMode != kOutOnly;
  constexpr int kSmem = (kStages ? kKRows * kRowFloats * 4 : 0) +
                        (kMode == kMxu ? kPix * kZStride * 4 : 0);
  auto kernel = exp_forward_kernel<kMode, kFieldMajor, kKRows, kOutCols>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  kernel<<<num_tiles + 1, kPix, kSmem, stream>>>(packed, crs, nch, schedule, num_tiles, tiles_x,
                                                   max_rows, out);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: 0 hs, 1 mxu, 2 nocp, 3 empty, 4 outonly, 5 alpha; field_major 1
// for E and F, 0 for G; krows 8 or 32; out_cols 8, or 1 for F.
extern "C" int exp_forward_launch(void* packed, void* crs, void* nch, void* schedule,
                                  int num_tiles, int tiles_x, int max_rows, int mode,
                                  int field_major, int krows, int out_cols, void* out,
                                  void* stream)
{
  if (num_tiles <= 0) return (int)cudaErrorInvalidValue;
  const float* pk = (const float*)packed;
  const int32_t* c = (const int32_t*)crs;
  const int32_t* nc = (const int32_t*)nch;
  const int32_t* sc = (const int32_t*)schedule;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define EXP_CASE(M, FM, KR, OC)                                                   \
  if (mode == M && field_major == FM && krows == KR && out_cols == OC)            \
    return launch<M, FM == 1, KR, OC>(pk, c, nc, sc, num_tiles, tiles_x, max_rows, o, s);
#define EXP_KROWS(M, FM, OC) EXP_CASE(M, FM, 8, OC) EXP_CASE(M, FM, 32, OC)
  EXP_KROWS(kHs, 1, 8)
  EXP_KROWS(kMxu, 1, 8)
  EXP_KROWS(kNocp, 1, 8)
  EXP_KROWS(kEmpty, 1, 8)
  EXP_KROWS(kOutOnly, 1, 8)
  EXP_KROWS(kAlpha, 1, 8)
  EXP_KROWS(kEmpty, 1, 1)
  EXP_KROWS(kOutOnly, 1, 1)
  EXP_KROWS(kAlpha, 1, 1)
  EXP_KROWS(kHs, 0, 8)
  EXP_KROWS(kMxu, 0, 8)
#undef EXP_KROWS
#undef EXP_CASE
  return (int)cudaErrorInvalidValue;
}
