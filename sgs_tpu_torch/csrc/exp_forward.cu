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
// Design. One thread per pixel of a 16x16 tile (256-thread blocks), the
// per-pixel state in registers; F alpha two pixels a thread (128-thread
// blocks, see "F alpha" below). The TPU grid runs in order on one core and
// carries the state in scratch from row to row; here a block walks each of
// its tiles' rows in order.
//   - Persistent blocks: as many blocks as the card holds at once (the
//     launcher asks the occupancy calculator), each taking the positions
//     b, 2G - 1 - b, 2G + b, ... of `schedule` (a snake over binning's
//     longest-first order, G blocks), whose (tile, first row, rows) it
//     reads once into a shared table. The rows past the last tile's
//     (no tile's) get the initial state, strided over the blocks.
//   - A ring of `krows` rows in shared memory fed by 16-byte cp.async
//     copies: the block's rows, across its tiles, form one sequence, and
//     while it walks row q the copies of rows up to q + krows - 1 are in
//     flight, the next tile's included (a 1080p tile holds about 2.9 rows,
//     so a ring inside one tile would hide almost nothing). One barrier per
//     row, which is also the tile-wide skip vote (__syncthreads_or of
//     t_run >= 1e-4): a row with no live pixel is skipped, its state still
//     written. Only what a mode reads is staged and allocated: of a
//     field-major row the first 9 fields (6 for F alpha), 2.25 KiB; of an
//     instance-major row (G) the first 3 of each record's 4 float4s, 3 KiB.
//   - Per row and pixel: alpha for the 64 instances (the JAX expression
//     term by term, built with --fmad=false), then
//     hs: the Hillis-Steele products cp[k] *= cp[k - s], s = 1 .. 32, the
//     TPU kernel's products, in registers;
//     mxu: z = log2(max(1 - a, 1e-30)) on the SFU; each warp forms its
//     32 pixels' inclusive sums zc = z @ tri one 8-column block at a
//     time: the lanes split their 8 z into TF32 high and low parts (once
//     per z) in the warp's 32 x 20 floats of shared memory, one mma.sync
//     m16n8k8 per 16 pixels and part against the 8x8 upper triangle gives
//     the block's inclusive sums (32 mma.sync per warp and row, the 8
//     blocks independent), and each lane adds its carry, the sum through
//     the block before, in f32, in order. cp = 2^zc, cp_prev = 2^zc[k-1]
//     (the previous lane's cp, one exp2 per pair; exp(sum of ln u) is
//     2^(sum of log2 u), within MXU_ATOL of the plain version);
//     nocp: cp = cp_prev = 1 - a;
//     then the weights, t_final, last_contrib and the colour sums by a
//     halving tree (v[i] + v[i + h], h = 32 .. 1), the order the plain
//     version spells out.
//   - hs: a warp none of whose pixels is live (t_run < 1e-4 for all 32)
//     skips the weights, t_final, last_contrib and the colour trees (their
//     result would leave its state as it is) and forms only t_run from the
//     63 Hillis-Steele products that cp[63] depends on, the same operands
//     in the same order. The vote stays tile-wide. At 1080p 6.2% of the
//     walked warps; the skip saves 3-5% on E hs and costs about as much on
//     mxu, so nocp and mxu walk every warp in full (tools/scan_ablation.py).
//   - The state goes out pixel-major, (256, 8) per row, for E and F (two
//     16-byte stores per thread), pixels-minor, (8, 256), for G (eight
//     coalesced 4-byte stores).
//
// Bound: operations (about 42 f32 operations per instance-pixel pair
// walked for E and G, 18 for F's alpha); each row reads 2.25 to 3 KiB of
// records and writes 8 KiB of state. Every array index is a compile-time
// constant (scan and tree levels are template parameters), or the 64-float
// arrays would go to local memory.
//
// Per instantiation at krows 8 / 32 (ptxas -v, the occupancy calculator,
// H100 80GB HBM3; tools/scan_ablation.py prints them): registers, spills,
// dynamic shared memory (the ring, and mxu's 20 KiB of z parts) beside the
// 3 KiB tile table, blocks per SM.
//   E hs    165, 0 B, 18,432 / 73,728 B, 1     G hs   250, 0 B, 24,576 / 98,304 B, 1
//   E mxu   241, 0 B, 38,912 / 94,208 B, 1     G mxu  255, 0 B, 45,056 / 118,784 B, 1
//   E nocp  126, 0 B, 18,432 / 73,728 B, 2     F outonly 40, 0 B, 0 (2 KiB table), 6
//   F empty 4, 0 B, 0, 8
//   F alpha (128 threads) 96, 0 B, 12,800 / 49,664 B (with the far thresholds), 5 / 4
// The 64 alphas and 64 products of a pixel hold 128 registers, so the
// scans run one block of 8 warps per SM and are bound by instruction
// issue (PERF.md gives the SASS counts and the issue share); so is F
// alpha, at 20 warps per SM (krows 8). Keeping the
// alphas in shared memory to fit two blocks spilled at 128 registers and
// was slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;
constexpr int kChunk = 64;
constexpr int kRec = 16;
constexpr int kRowFloats = kChunk * kRec;
constexpr int kState = 8;
constexpr int kZStride = 20;  // a lane's row of z parts: hi 0-7, lo 8-15; fragment loads hit 32 banks
constexpr int kMaxTiles = 256;  // the tile table's entries: rounds of the schedule per block
constexpr float kAlphaMax = 0.99f;
constexpr float kAlphaMin = (float)(1.0 / 255.0);
constexpr float kEps = 1e-4f;

enum Mode { kHs = 0, kMxu = 1, kNocp = 2, kEmpty = 3, kOutOnly = 4, kAlpha = 5 };

// F alpha's design choices (tools/scan_ablation.py times each undone):
constexpr int kAlphaPix = 2;           // pixels per thread: one column, two neighbouring rows
constexpr bool kAlphaPrescale = true;  // conic a and c scaled by -0.5 in the ring, once per row
constexpr bool kAlphaSkip = true;      // no exp for a record far from all of a warp's pixels
constexpr int kAlphaMinBlocks = 5;     // blocks per SM ptxas must fit (at most 102 registers)
// How far below ln(kAlphaMin / opacity) a power must lie to be skipped:
// it covers the rounding of the threshold (a few 1e-7 relative) and of
// expf (2 ulp) many times over.
constexpr float kFarMargin = 1e-3f;

template <int kMode>
__host__ __device__ constexpr int pixels_per_thread() { return kMode == kAlpha ? kAlphaPix : 1; }

template <int kMode>
__host__ __device__ constexpr int block_threads() { return kPix / pixels_per_thread<kMode>(); }

// What a mode stages of a row: field-major (E, F) the first kFields
// fields, contiguous; instance-major (G) float4s 0-2 of each record
// (fields 0-11), packed 12 floats a record.
template <int kMode, bool kFieldMajor>
struct Stage {
  static constexpr int kFields = kMode == kAlpha ? 6 : 9;
  static constexpr int kVecs = kFieldMajor ? kFields * kChunk / 4 : kChunk * 3;
  static constexpr bool kReads = kMode != kEmpty && kMode != kOutOnly;
};

constexpr int kRecStaged = 12;  // floats of a staged instance-major record

struct Rec {
  float mx, my, ca, cb, cc, op;
};

template <bool kFieldMajor>
__device__ __forceinline__ Rec load_rec(const float* row, int k) {
  if constexpr (kFieldMajor) {
    return {row[k], row[kChunk + k], row[2 * kChunk + k], row[3 * kChunk + k],
            row[4 * kChunk + k], row[5 * kChunk + k]};
  } else {  // x, y, conic a, b and conic c, opacity: not the colour, read later
    const float4 q0 = *reinterpret_cast<const float4*>(row + k * kRecStaged);
    const float2 q1 = *reinterpret_cast<const float2*>(row + k * kRecStaged + 4);
    return {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y};
  }
}

// Channel c of the staged row's colours: field-major, a field of 64;
// instance-major, every 12th float from offset 6 + c, through a pointer
// the compiler cannot relate to the other channels', so that it does not
// load the three channels together and keep two of them live through the
// first channel's sum (which spilled the registers). The loads become
// generic loads; an opaque offset on the shared base kept them shared
// loads but let the compiler hoist them, and spilled again.
template <bool kFieldMajor>
__device__ __forceinline__ const float* rgb_channel(const float* row, int c) {
  if constexpr (kFieldMajor) return row + (6 + c) * kChunk;
  const float* ch = row + 6 + c;
  asm("" : "+l"(ch));
  return ch;
}

__device__ __forceinline__ float alpha_from(float power, float op) {
  const float alpha = fminf(kAlphaMax, op * expf(power));
  return (power <= 0.0f && alpha >= kAlphaMin) ? alpha : 0.0f;
}

__device__ __forceinline__ float alpha_of(const Rec& r, float fx, float fy) {
  const float dx = r.mx - fx;
  const float dy = r.my - fy;
  return alpha_from(-0.5f * (r.ca * dx * dx + r.cc * dy * dy) - r.cb * dx * dy, r.op);
}

// ---------------------------------------------------------------- F alpha
//
// Per row and pixel F sums the 64 alphas by the halving tree (v[i] +
// v[i + h], h = 32 .. 1), bit for bit as the plain version. It is bound
// by instruction issue, so the design cuts instructions per pair:
//   - two pixels a thread, (x, y) and (x, y + 1): dx, the conic a term
//     and cb dx are formed once for both, and every shared load serves
//     both (128-thread blocks);
//   - -0.5 conic a and -0.5 conic c in the ring: ((-0.5 a) dx) dx +
//     ((-0.5 c) dy) dy has the bits of -0.5 (a dx dx + c dy dy) (a power
//     of two scales every rounding alike), one multiply fewer per pair;
//   - the records in groups of 4 (m = 0 .. 15: records 4m .. 4m + 3),
//     each field of a group one 16-byte broadcast load (PR 10's loads of
//     single records compiled to those too). A group holds one
//     leaf of each of the tree's four subtrees by k mod 4 (the levels h =
//     32 .. 4 combine leaves of one residue, h = 2 and 1 the four
//     subtrees), so the groups run in bit-reversed order and a binary
//     counter adds each subtree's nodes as soon as both halves exist: a
//     handful of partial sums live, not 64 alphas;
//   - a warp computes no exp for a record whose power is below its far
//     threshold ln(kAlphaMin / opacity) - kFarMargin at all of its 64
//     pixels: there op * expf(power) < kAlphaMin for certain, so the
//     alpha is 0, as the full expression gives (the vote is warp-uniform;
//     the 0 goes into the tree in its place). The thresholds are formed
//     once per row into a two-row buffer past the ring;
//   - the 16 groups as a loop of 4 passes of 4 (unrolled, the row's code
//     overflowed the instruction cache), and a launch bound of
//     kAlphaMinBlocks blocks per SM.

// The far threshold of a record's power, formed once per row.
__device__ __forceinline__ float far_power(float op) { return logf(kAlphaMin / op) - kFarMargin; }

// After thread t's copies of a row have landed: each float4 v it copied
// (field v / 16, records 4 (v % 16) .. + 3; `fetch_row`) scaled by -0.5
// if it is conic a or c, and from the opacities the records' far
// thresholds, written to `far` (64 floats; two of them alternate by row,
// so that a row's are written only after every thread is past the row
// two before). The barrier that follows publishes both.
template <int kThreads>
__device__ __forceinline__ void prepare_alpha(float4* slot, float4* far, int t) {
  constexpr int kVecs = Stage<kAlpha, true>::kVecs;
#pragma unroll
  for (int j = 0; j < (kVecs + kThreads - 1) / kThreads; ++j) {
    const int v = t + j * kThreads;
    const int field = v / (kChunk / 4);
    if (kAlphaPrescale && (field == 2 || field == 4)) {
      const float4 q = slot[v];
      slot[v] = make_float4(-0.5f * q.x, -0.5f * q.y, -0.5f * q.z, -0.5f * q.w);
    }
    if (kAlphaSkip && field == 5) {
      const float4 op = slot[v];
      far[v % (kChunk / 4)] = make_float4(far_power(op.x), far_power(op.y), far_power(op.z), far_power(op.w));
    }
  }
}

// Field f of records 4m .. 4m + 3 of a field-major row, one 16-byte load
// (four scalar loads compile to the same LDS.128).
__device__ __forceinline__ void field4(const float* row, int f, int m, float (&v)[4]) {
  const float4 q = reinterpret_cast<const float4*>(row)[f * (kChunk / 4) + m];
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// The alphas of records 4m .. 4m + 3 at the thread's kPP pixels (`far`:
// the row's far thresholds).
template <int kPP>
__device__ __forceinline__ void alpha_group(const float* row, const float* far_row, int m, float fx,
                                            const float (&fy)[kPP], float (&x)[4][kPP]) {
  float mx[4], my[4], ca[4], cb[4], cc[4], op[4], far[4];
  field4(row, 0, m, mx);
  field4(row, 1, m, my);
  field4(row, 2, m, ca);
  field4(row, 3, m, cb);
  field4(row, 4, m, cc);
  field4(row, 5, m, op);
  if constexpr (kAlphaSkip) field4(far_row, 0, m, far);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float dx = mx[c] - fx;
    const float ax = ca[c] * dx * dx;
    const float bx = cb[c] * dx;
    float power[kPP];
    bool is_far = true;
#pragma unroll
    for (int i = 0; i < kPP; ++i) {
      const float dy = my[c] - fy[i];
      const float q = ax + cc[c] * dy * dy;
      power[i] = (kAlphaPrescale ? q : -0.5f * q) - bx * dy;
      if constexpr (kAlphaSkip) is_far = is_far && power[i] < far[c];
    }
    if (kAlphaSkip && __all_sync(0xffffffffu, is_far)) {
#pragma unroll
      for (int i = 0; i < kPP; ++i) x[c][i] = 0.0f;
    } else {
#pragma unroll
      for (int i = 0; i < kPP; ++i) x[c][i] = alpha_from(power[i], op[c]);
    }
  }
}

// The counter's levels 0 and 1 over the four groups kLo = 0 .. 3 of one
// pass (processing order 4 hi + kLo): while bit kL of kLo is set, the node
// stored at level kL is the left half of x; the pass's level-2 node goes
// to y.
template <int kLo, int kL, int kPP>
__device__ __forceinline__ void carry(float (&node)[2][4][kPP], float (&x)[4][kPP], float (&y)[4][kPP]) {
  if constexpr (kL < 2 && ((kLo >> kL) & 1)) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < kPP; ++i) x[c][i] = node[kL][c][i] + x[c][i];
    carry<kLo, kL + 1>(node, x, y);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < kPP; ++i) {
        if constexpr (kL == 2) y[c][i] = x[c][i];
        else node[kL][c][i] = x[c][i];
      }
  }
}

// The four groups of pass hi, m = bitrev(4 hi + kLo) = bitrev2(kLo) * 4 +
// m_hi (m_hi = bitrev2(hi)), into the pass's level-2 node y.
template <int kLo, int kPP>
__device__ __forceinline__ void pass_groups(const float* row, const float* far_row, int m_hi, float fx,
                                            const float (&fy)[kPP], float (&node)[2][4][kPP], float (&y)[4][kPP]) {
  if constexpr (kLo < 4) {
    float x[4][kPP];
    alpha_group<kPP>(row, far_row, (((kLo & 1) << 3) | ((kLo & 2) << 1)) | m_hi, fx, fy, x);
    carry<kLo, 0>(node, x, y);
    pass_groups<kLo + 1>(row, far_row, m_hi, fx, fy, node, y);
  }
}

// The halving-tree sum of a row's 64 alphas at each of the kPP pixels: four
// passes hi = 0 .. 3 in a loop (unrolled, the row's code overflowed the
// instruction cache and ran slower than PR 10's), each four groups
// unrolled; the passes' level-2 nodes combine at levels 2 and 3 by the
// bits of hi (warp-uniform branches), then the four subtrees' roots.
template <int kPP>
__device__ __forceinline__ void alpha_row(const float* row, const float* far_row, float fx, const float (&fy)[kPP],
                                          float (&sum)[kPP]) {
  float lvl2[4][kPP], lvl3[4][kPP], root[4][kPP];
#pragma unroll 1
  for (int hi = 0; hi < 4; ++hi) {
    float node[2][4][kPP], y[4][kPP];
    pass_groups<0>(row, far_row, ((hi & 1) << 1) | (hi >> 1), fx, fy, node, y);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int i = 0; i < kPP; ++i) {
        if (!(hi & 1)) {
          lvl2[c][i] = y[c][i];
        } else if (!(hi & 2)) {
          lvl3[c][i] = lvl2[c][i] + y[c][i];
        } else {
          root[c][i] = lvl3[c][i] + (lvl2[c][i] + y[c][i]);
        }
      }
  }
#pragma unroll
  for (int i = 0; i < kPP; ++i) sum[i] = (root[0][i] + root[2][i]) + (root[1][i] + root[3][i]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The levels of the halving tree from stride kH down, each stride a
// template constant so that every index is known at compile time and the
// arrays stay in registers.
template <int kH, int kN>
__device__ __forceinline__ void tree_down(float (&v)[kN]) {
  if constexpr (kH >= 1) {
#pragma unroll
    for (int i = 0; i < kH; ++i) v[i] = v[i] + v[i + kH];
    tree_down<kH / 2>(v);
  }
}

template <int kN>
__device__ __forceinline__ float tree_sum(float (&v)[kN]) {
  tree_down<kN / 2>(v);
  return v[0];
}

// One Hillis-Steele step: cp[k] *= cp[k - s] for k >= s, top down, so
// each product reads the level's old cp[k - s].
template <int kS>
__device__ __forceinline__ void scan_level(float (&cp)[kChunk]) {
#pragma unroll
  for (int k = kChunk - 1; k >= kS; --k) cp[k] = cp[k] * cp[k - kS];
}

// The products of one Hillis-Steele step that cp[63] depends on: k = 63,
// 63 - 2s, ... (k = -1 mod 2s). cp[k - s] is not one of them, so it still
// holds the level before, as in scan_level.
template <int kS>
__device__ __forceinline__ void last_level(float (&cp)[kChunk]) {
#pragma unroll
  for (int k = kChunk - 1; k >= 2 * kS - 1; k -= 2 * kS) cp[k] = cp[k] * cp[k - kS];
}

// mxu's logarithm and exponential in base 2 on the SFU: z = log2(u) with
// __log2f (2^-22 absolute for u in [0.5, 2], 2 ulp below), cp = 2^zc with
// exp2f (2 ulp); exp(sum of ln u) = 2^(sum of log2 u). A lane with alpha
// 0 (u = 1) keeps z = 0 exactly, as the plain version's log(1) does.
__device__ __forceinline__ float log2_transmittance(float u) {
  return u < 1.0f ? __log2f(fmaxf(u, 1e-30f)) : 0.0f;
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

// The inclusive sums of a warp's 32 rows of z (one row per lane, in its
// registers), in place: zc[k] = sum of z[0 .. k]. For each 8-column block
// the lane writes its 8 values' TF32 high and low parts to its row of
// `s` (the warp's 32 x kZStride floats), the warp multiplies each 16 rows
// and part by the 8x8 upper triangle (tri[k][n] = k <= n, exact in TF32,
// so the third product of 3xTF32 is zero and left out), low part first,
// and writes the block's inclusive sums back over the high parts; the
// lane adds its carry, zc of the block's last column before, in f32.
__device__ __forceinline__ void warp_cumsum(float (&z)[kChunk], float* s, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t one = 0x3f800000u;  // 1.0f
  const uint32_t b0 = t <= g ? one : 0u;
  const uint32_t b1 = t + 4 <= g ? one : 0u;
  float* mine = s + lane * kZStride;
  float carry = 0.0f;
#pragma unroll
  for (int nn = 0; nn < kChunk / 8; ++nn) {
    float hi[8], lo[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      hi[c] = __uint_as_float(to_tf32(z[8 * nn + c]));
      lo[c] = __uint_as_float(to_tf32(z[8 * nn + c] - hi[c]));
    }
    float4* m4 = reinterpret_cast<float4*>(mine);
    m4[0] = make_float4(hi[0], hi[1], hi[2], hi[3]);
    m4[1] = make_float4(hi[4], hi[5], hi[6], hi[7]);
    m4[2] = make_float4(lo[0], lo[1], lo[2], lo[3]);
    m4[3] = make_float4(lo[4], lo[5], lo[6], lo[7]);
    __syncwarp();
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint32_t* r0 = reinterpret_cast<const uint32_t*>(s + (mi * 16 + g) * kZStride);
      const uint32_t* r8 = r0 + 8 * kZStride;
      mma_tf32(acc[mi], r0[8 + t], r8[8 + t], r0[12 + t], r8[12 + t], b0, b1);
      mma_tf32(acc[mi], r0[t], r8[t], r0[4 + t], r8[4 + t], b0, b1);
    }
    __syncwarp();  // every fragment is loaded before the sums overwrite the parts
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      float* r0 = s + (mi * 16 + g) * kZStride + 2 * t;
      *reinterpret_cast<float2*>(r0) = make_float2(acc[mi][0], acc[mi][1]);
      *reinterpret_cast<float2*>(r0 + 8 * kZStride) = make_float2(acc[mi][2], acc[mi][3]);
    }
    __syncwarp();
    const float4 w0 = m4[0];
    const float4 w1 = m4[1];
    const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int c = 0; c < 8; ++c) z[8 * nn + c] = carry + w[c];
    carry = z[8 * nn + 7];
  }
}

// One row of E or G for pixel p: st is [r, g, b, t_run, t_final, last, 0,
// 0]; s_z: mxu's z parts, the block's shared memory past the ring.
template <int kMode, bool kFieldMajor>
__device__ __forceinline__ void composite_row(const float* row, int r, int p, float fx, float fy,
                                              float (&st)[kState], float* s_z) {
  const float t_row = st[3];
  float a[kChunk], cp[kChunk];  // a: the alphas, then the weights
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    a[k] = alpha_of(load_rec<kFieldMajor>(row, k), fx, fy);
    cp[k] = 1.0f - a[k];
  }
  if constexpr (kMode == kHs) {
    if (!__any_sync(0xffffffffu, t_row >= kEps)) {  // no live pixel in the warp
      last_level<1>(cp);
      last_level<2>(cp);
      last_level<4>(cp);
      last_level<8>(cp);
      last_level<16>(cp);
      last_level<32>(cp);
      st[3] = t_row * cp[kChunk - 1];
      return;
    }
    scan_level<1>(cp);
    scan_level<2>(cp);
    scan_level<4>(cp);
    scan_level<8>(cp);
    scan_level<16>(cp);
    scan_level<32>(cp);
  }
  if constexpr (kMode == kMxu) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) cp[k] = log2_transmittance(cp[k]);  // z
    warp_cumsum(cp, s_z + (p >> 5) * 32 * kZStride, p & 31);        // zc
  }
  // last_contrib: the position of the last instance included; positions
  // grow with k, so the max over the included is the last one's
  float tf = 1.0f, t_run = t_row, prev = 1.0f;
  int k_last = -1;
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    float cpk, cppk;
    if constexpr (kMode == kMxu) {
      cpk = exp2f(cp[k]);
      cppk = prev;
      prev = cpk;
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
      k_last = k;
    }
    if (k == kChunk - 1) t_run = s;
  }
  const float last = k_last >= 0 ? ((float)(r * kChunk) + (float)k_last) + 1.0f : 0.0f;
  // the colour sums, the tree's first level (k + 32 onto k) taken as the
  // products are formed, so that 32 of them are live at once
  constexpr int kStride = kFieldMajor ? 1 : kRecStaged;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* ch = rgb_channel<kFieldMajor>(row, c);
    float v[kChunk / 2];
#pragma unroll
    for (int i = 0; i < kChunk / 2; ++i)
      v[i] = a[i] * ch[i * kStride] + a[i + kChunk / 2] * ch[(i + kChunk / 2) * kStride];
    st[c] = st[c] + tree_sum(v);
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

template <int kMode>
__device__ __forceinline__ void initial_state(float (&st)[kState]) {
  const bool zero_init = kMode == kOutOnly || kMode == kAlpha;
#pragma unroll
  for (int c = 0; c < kState; ++c) st[c] = (!zero_init && (c == 3 || c == 4)) ? 1.0f : 0.0f;
}

// A position in a block's sequence of rows: entry j of its tile table and
// the row within that tile; j == rounds past the end. Uniform over the
// block.
struct Cursor {
  int j, row;
};

__device__ __forceinline__ void settle(Cursor& c, const int* s_n, int rounds) {
  while (c.j < rounds && c.row >= s_n[c.j]) {
    c.row = 0;
    ++c.j;
  }
}

__device__ __forceinline__ void advance(Cursor& c, const int* s_n, int rounds) {
  ++c.row;
  settle(c, s_n, rounds);
}

// Thread t's 16-byte copies of row r into a ring slot: float4s v = t,
// t + kThreads, ... of what the mode stages (E, F: float4 v of the row;
// G: float4 v % 3 of record v / 3).
template <int kMode, bool kFieldMajor>
__device__ __forceinline__ void fetch_row(float4* slot, const float* __restrict__ packed, int r, int t) {
  constexpr int kVecs = Stage<kMode, kFieldMajor>::kVecs;
  constexpr int kThreads = block_threads<kMode>();
  const float4* src = reinterpret_cast<const float4*>(packed + (int64_t)r * kRowFloats);
#pragma unroll
  for (int j = 0; j < (kVecs + kThreads - 1) / kThreads; ++j) {
    const int v = t + j * kThreads;
    if (v < kVecs) cp_async16(slot + v, src + (kFieldMajor ? v : (v / 3) * (kRec / 4) + v % 3));
  }
}

template <int kMode, bool kFieldMajor, int kRing, int kOutCols>
__global__ void __launch_bounds__(block_threads<kMode>(), kMode == kAlpha ? kAlphaMinBlocks : 1)
exp_forward_kernel(const float* __restrict__ packed,  // (rows, 1024) records
                   const int32_t* __restrict__ crs,   // (T,) first row of each tile
                   const int32_t* __restrict__ nch,   // (T,) rows of each tile
                   const int32_t* __restrict__ schedule,  // (T,) tiles, longest first
                   int num_tiles, int tiles_x, int max_rows,
                   float* __restrict__ out)
{
  if constexpr (kMode == kEmpty) return;
  using S = Stage<kMode, kFieldMajor>;
  constexpr int kPP = pixels_per_thread<kMode>();
  constexpr int kThreads = block_threads<kMode>();
  static_assert((kRing & (kRing - 1)) == 0 && kRing >= 2, "the ring's rows are a power of two");
  extern __shared__ float4 smem4[];
  float4* ring = smem4;
  // past the ring: mxu's z parts, or F alpha's far thresholds of two rows
  float* s_z = reinterpret_cast<float*>(smem4 + (S::kReads ? kRing * S::kVecs : 0));
  __shared__ int s_tile[kMaxTiles], s_r0[kMaxTiles], s_n[kMaxTiles];
  const int t = threadIdx.x;
  const int blocks = gridDim.x;
  const int b = blockIdx.x;
  // the thread's pixels: column t % 16 of rows (t / 16) kPP + i
  int pix[kPP];
#pragma unroll
  for (int i = 0; i < kPP; ++i) pix[i] = ((t / kTile) * kPP + i) * kTile + t % kTile;
  float st[kPP][kState];
#pragma unroll
  for (int i = 0; i < kPP; ++i) initial_state<kMode>(st[i]);

  // rows past the last tile's (no tile's): the initial state
  for (int r = crs[num_tiles - 1] + nch[num_tiles - 1] + b; r < max_rows; r += blocks)
#pragma unroll
    for (int i = 0; i < kPP; ++i) write_state<kFieldMajor, kOutCols>(out, r, pix[i], st[i]);

  // this block's tiles: schedule positions b, 2G - 1 - b, 2G + b, ...
  const int rounds = (num_tiles + blocks - 1) / blocks;
  for (int j = t; j < rounds; j += kThreads) {
    const int i = j * blocks + ((j & 1) ? blocks - 1 - b : b);
    int tile = 0, r0 = 0, n = 0;
    if (i < num_tiles) {
      tile = schedule[i];
      r0 = crs[tile];
      n = nch[tile];
    }
    s_tile[j] = tile;
    s_r0[j] = r0;
    s_n[j] = n;
  }
  __syncthreads();

  Cursor cc{0, 0}, pc{0, 0};  // the row walked, the row fetched next
  settle(cc, s_n, rounds);
  settle(pc, s_n, rounds);
  if constexpr (S::kReads) {  // rows 0 .. krows - 2 in flight
    for (int q = 0; q < kRing - 1; ++q) {
      if (pc.j < rounds) {
        fetch_row<kMode, kFieldMajor>(ring + q * S::kVecs, packed, s_r0[pc.j] + pc.row, t);
        advance(pc, s_n, rounds);
      }
      cp_async_commit();
    }
  }
  float fx = 0.0f, fy[kPP] = {};
  for (int q = 0; cc.j < rounds; ++q) {
    const int r = s_r0[cc.j] + cc.row;
    if (cc.row == 0) {
      const int tile = s_tile[cc.j];
      fx = (float)((tile % tiles_x) * kTile) + (float)(t % kTile);
#pragma unroll
      for (int i = 0; i < kPP; ++i) {
        fy[i] = (float)((tile / tiles_x) * kTile) + (float)(pix[i] / kTile);
        initial_state<kMode>(st[i]);
      }
    }
    float4* slot = ring + (q & (kRing - 1)) * S::kVecs;
    float* far_row = s_z + (q & 1) * kChunk;
    bool go = false;
    if constexpr (S::kReads) {
      cp_async_wait<kRing - 2>();  // this thread's copies of row q have landed
      if constexpr (kMode == kAlpha) prepare_alpha<kThreads>(slot, reinterpret_cast<float4*>(far_row), t);
      // every thread's copies visible, every thread done with row q - 1
      go = __syncthreads_or(st[0][3] >= kEps);
      if (pc.j < rounds) {  // row q + krows - 1, into the slot of row q - 1
        fetch_row<kMode, kFieldMajor>(ring + ((q + kRing - 1) & (kRing - 1)) * S::kVecs, packed,
                                      s_r0[pc.j] + pc.row, t);
        advance(pc, s_n, rounds);
      }
      cp_async_commit();
    }
    const float* rowf = reinterpret_cast<const float*>(slot);
    if constexpr (kMode == kAlpha) {
      float v[kPP];
      alpha_row<kPP>(rowf, far_row, fx, fy, v);
#pragma unroll
      for (int i = 0; i < kPP; ++i) st[i][0] = st[i][0] + v[i];
    } else if constexpr (kMode == kHs || kMode == kMxu || kMode == kNocp) {
      if (go) composite_row<kMode, kFieldMajor>(rowf, r, t, fx, fy[0], st[0], s_z);
    }
#pragma unroll
    for (int i = 0; i < kPP; ++i) write_state<kFieldMajor, kOutCols>(out, r, pix[i], st[i]);
    advance(cc, s_n, rounds);
  }
  if constexpr (S::kReads) cp_async_wait<0>();
}

template <int kMode, bool kFieldMajor, int kRing>
constexpr int smem_bytes() {
  using S = Stage<kMode, kFieldMajor>;
  constexpr int kExtra = kMode == kMxu ? kPix * kZStride * 4 : kMode == kAlpha && kAlphaSkip ? 2 * kChunk * 4 : 0;
  return (S::kReads ? kRing * S::kVecs * 16 : 0) + kExtra;
}

// Blocks of one instantiation resident per SM (the occupancy calculator),
// after raising its dynamic shared memory limit; negative on a CUDA error.
template <int kMode, bool kFieldMajor, int kRing, int kOutCols>
int resident_blocks() {
  static int per_sm = 0;
  if (per_sm == 0) {
    auto kernel = exp_forward_kernel<kMode, kFieldMajor, kRing, kOutCols>;
    constexpr int kSmem = smem_bytes<kMode, kFieldMajor, kRing>();
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, block_threads<kMode>(), kSmem);
    if (e != cudaSuccess) return -(int)e;
    if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  }
  return per_sm;
}

template <int kMode, bool kFieldMajor, int kRing, int kOutCols>
int launch(const float* packed, const int32_t* crs, const int32_t* nch, const int32_t* schedule,
           int num_tiles, int tiles_x, int max_rows, float* out, cudaStream_t stream) {
  const int per_sm = resident_blocks<kMode, kFieldMajor, kRing, kOutCols>();
  if (per_sm < 0) return -per_sm;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // as many blocks as fit at once, fewer for a small view, more when a
  // block's table would overflow
  int grid = per_sm * sms < num_tiles ? per_sm * sms : num_tiles;
  if (grid < (num_tiles + kMaxTiles - 1) / kMaxTiles) grid = (num_tiles + kMaxTiles - 1) / kMaxTiles;
  exp_forward_kernel<kMode, kFieldMajor, kRing, kOutCols>
      <<<grid, block_threads<kMode>(), smem_bytes<kMode, kFieldMajor, kRing>(), stream>>>(
          packed, crs, nch, schedule, num_tiles, tiles_x, max_rows, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define EXP_INSTANCES(X)                                            \
  X(kHs, 1, 8, 8) X(kHs, 1, 32, 8) X(kMxu, 1, 8, 8) X(kMxu, 1, 32, 8) \
  X(kNocp, 1, 8, 8) X(kNocp, 1, 32, 8)                                \
  X(kEmpty, 1, 8, 8) X(kEmpty, 1, 32, 8) X(kOutOnly, 1, 8, 8) X(kOutOnly, 1, 32, 8) \
  X(kAlpha, 1, 8, 8) X(kAlpha, 1, 32, 8)                              \
  X(kEmpty, 1, 8, 1) X(kEmpty, 1, 32, 1) X(kOutOnly, 1, 8, 1) X(kOutOnly, 1, 32, 1) \
  X(kAlpha, 1, 8, 1) X(kAlpha, 1, 32, 1)                              \
  X(kHs, 0, 8, 8) X(kHs, 0, 32, 8) X(kMxu, 0, 8, 8) X(kMxu, 0, 32, 8)

// mode: 0 hs, 1 mxu, 2 nocp, 3 empty, 4 outonly, 5 alpha; field_major 1
// for E and F, 0 for G; krows (the ring's rows) 8 or 32; out_cols 8, or 1
// for F.
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
  EXP_INSTANCES(EXP_CASE)
#undef EXP_CASE
  return (int)cudaErrorInvalidValue;
}

// The blocks of an instantiation resident per SM (what the launcher
// gives each SM); negative on a CUDA error.
extern "C" int exp_forward_blocks_per_sm(int mode, int field_major, int krows, int out_cols)
{
#define EXP_CASE(M, FM, KR, OC)                                                   \
  if (mode == M && field_major == FM && krows == KR && out_cols == OC)            \
    return resident_blocks<M, FM == 1, KR, OC>();
  EXP_INSTANCES(EXP_CASE)
#undef EXP_CASE
  return -(int)cudaErrorInvalidValue;
}
