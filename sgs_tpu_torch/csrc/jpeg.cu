// JPEG decoding on the host, equal bit for bit to PIL's (libjpeg-turbo's)
// output and to the plain version in data/jpeg.py.
//
// Host code only: nvcc's host compiler builds it into the same kind of
// ctypes library as the kernels (ops/build.py). Python parses the markers
// (data/jpeg.py::parse_jpeg) and calls, per scan, jpeg_decode_scan
// (sequential) or jpeg_decode_progressive_scan on the scan's entropy-coded
// bytes (stuffing and restart markers included); for a progressive file
// whose coefficients are not all known, jpeg_smooth on each component;
// then once jpeg_reconstruct on the coefficients:
//   - Huffman decoding through 16-bit lookup tables (symbol | length << 8,
//     built in Python), DC prediction (and a progressive scan's end-of-band
//     run) reset at each restart marker, zero bits fed past a marker as
//     libjpeg feeds them;
//   - jdphuff.c's four progressive scan kinds; where a progressive scan's
//     data ends early the MCU is completed with zero bits and nothing more
//     is decoded until a restart marker, and a bit string that is no code
//     takes 17 bits and decodes as symbol 0, as libjpeg does;
//   - jdcoefct.c's decompress_smooth_data (5x5 DC neighbourhoods, the
//     kernels of data/jpeg.py) into a copy of a component's coefficients;
//   - dequantisation and the islow IDCT as libjpeg-turbo's SIMD version
//     computes it (16-bit dequantisation and even/odd sums, pass 1 saturated
//     to 16 bits, or the first row shifted in 16 bits for a block whose
//     other rows are zero, samples clamped to 0..255);
//   - jdsample.c's fancy upsampling (h2v1, h1v2, h2v2 triangle filters,
//     edges replicated) or replication, and jdcolor.c's YCbCr -> RGB.
// Return codes: 0 ok, 1 a bad Huffman code, 2 the data ended inside an
// MCU, 3 a restart marker missing, 4 an unsupported sampling ratio (the
// first three in sequential scans only).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// Bit reader over one scan's bytes, as jdhuff.c's fill_bit_buffer: 0xFF00
// is a 0xFF data byte, fill bytes 0xFF before a marker are skipped, and at
// a marker (or the end of the bytes) zeros are fed in.
struct Bits {
  const uint8_t* data;
  int64_t len, p;
  uint64_t buf;
  int nbits;
  bool at_marker;
  int64_t consumed, real;  // bits taken in this restart interval; real bits loaded

  void start() {
    buf = 0;
    nbits = 0;
    at_marker = false;
    consumed = 0;
    real = 0;
  }
  void fill() {
    while (nbits <= 56) {
      int byte = 0;
      if (!at_marker && p < len) {
        int c = data[p];
        if (c == 0xFF) {
          int64_t q = p + 1;
          while (q < len && data[q] == 0xFF) q++;
          if (q < len && data[q] == 0x00) {
            byte = 0xFF;
            p = q + 1;
            real += 8;
          } else {
            at_marker = true;  // p stays on the fill bytes before the marker
          }
        } else {
          byte = c;
          p++;
          real += 8;
        }
      } else {
        at_marker = true;
      }
      buf |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  inline uint32_t peek16() {
    if (nbits < 16) fill();
    return (uint32_t)(buf >> 48);
  }
  inline void skip(int n) {
    buf <<= n;
    nbits -= n;
    consumed += n;
  }
  inline int get(int n) {
    if (nbits < n) fill();
    int v = (int)(buf >> (64 - n));
    skip(n);
    return v;
  }
  // the restart marker after an interval: drop the bits left in the buffer
  // (the interval's padding) and step over 0xFF* RSTn, which the bytes not
  // yet loaded start with
  bool restart() {
    int64_t q = p;
    if (q >= len || data[q] != 0xFF) return false;
    while (q < len && data[q] == 0xFF) q++;
    if (q >= len || data[q] < 0xD0 || data[q] > 0xD7) return false;
    p = q + 1;
    start();
    return true;
  }
  // a progressive scan's restart: skip what is left of the interval up to
  // the next marker (jdmarker.c, next_marker); an RSTn starts the next
  // interval, anything else leaves the reader at the end of the data
  bool restart_progressive() {
    int64_t q = p;
    for (;;) {
      while (q < len && data[q] != 0xFF) q++;
      int64_t r = q;
      while (r < len && data[r] == 0xFF) r++;
      if (r >= len) break;
      if (data[r] != 0x00) {
        if (data[r] >= 0xD0 && data[r] <= 0xD7) {
          p = r + 1;
          start();
          return true;
        }
        break;
      }
      q = r + 1;  // a stuffed 0xFF data byte
    }
    p = len;
    start();
    at_marker = true;
    return false;
  }
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + 1 - (1 << s) : r; }

// jpeg_natural_order with its 16 extra entries: a run past coefficient 63
// writes coefficient 63
const int kNatural[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// one Huffman symbol; a bit string that is no code takes 17 bits and
// decodes as symbol 0, as jpeg_huff_decode fakes it
inline int progressive_symbol(Bits& bits, const int32_t* lut) {
  int e = lut[bits.peek16()];
  if (e == 0) {
    if (bits.nbits < 17) bits.fill();
    bits.skip(17);
    return 0;
  }
  bits.skip(e >> 8);
  return e & 0xFF;
}

// decompress_smooth_data's 5x5 DC kernels (rows top to bottom) per zigzag
// coefficient 0..9, with no AC coefficient coded yet ("change_dc"), and
// per coefficient 1..5 otherwise; the same numbers as data/jpeg.py's
const int kSmoothDC[10][25] = {
    {-2, -6, -8, -6, -2, -6, 6, 42, 6, -6, -8, 42, 152, 42, -8, -6, 6, 42, 6, -6, -2, -6, -8, -6, -2},
    {-1, -1, 0, 1, 1, -3, 13, 0, -13, 3, -3, 38, 0, -38, 3, -3, 13, 0, -13, 3, -1, -1, 0, 1, 1},
    {-1, -3, -3, -3, -1, -1, 13, 38, 13, -1, 0, 0, 0, 0, 0, 1, -13, -38, -13, 1, 1, 3, 3, 3, 1},
    {0, 0, 1, 0, 0, 0, 2, 7, 2, 0, 0, -5, -14, -5, 0, 0, 2, 7, 2, 0, 0, 0, 1, 0, 0},
    {-1, 0, 0, 0, 1, 0, 9, 0, -9, 0, 0, 0, 0, 0, 0, 0, -9, 0, 9, 0, 1, 0, 0, 0, -1},
    {0, 0, 0, 0, 0, 0, 2, -5, 2, 0, 1, 7, -14, 7, 1, 0, 2, -5, 2, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, 2, 0, -2, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, -3, 1, 0, 0, 0, 0, 0, 0, 0, -1, 3, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 0, -1, 0, 0, -3, 0, 3, 0, 0, 1, 0, -1, 0, 0, 0, 0, 0, 0},
    {0, 0, 0, 0, 0, 0, 1, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -1, 0, 0, 0, 0, 0, 0}};
const int kSmoothAC[6][25] = {
    {0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -7, 50, 0, -50, 7, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0},
    {0, 0, -7, 0, 0, 0, 0, 50, 0, 0, 0, 0, 0, 0, 0, 0, 0, -50, 0, 0, 0, 0, 7, 0, 0},
    {0, 0, -1, 0, 0, 0, 0, 13, 0, 0, 0, 0, -24, 0, 0, 0, 0, 13, 0, 0, 0, 0, -1, 0, 0},
    {0, -1, 0, 1, 0, -1, 10, 0, -10, 1, 0, 0, 0, 0, 0, 1, -10, 0, 10, -1, 0, 1, 0, -1, 0},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, -1, 13, -24, 13, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0}};

// round(num / (q * 256)) away from zero at halves, the magnitude capped
// below 2^al when al > 0 low bits are unknown
inline int64_t smooth_estimate(int64_t num, int64_t q, int al, bool clamp) {
  int64_t a = (q * 128 + (num < 0 ? -num : num)) / (q * 256);
  if (clamp && al > 0 && a >= ((int64_t)1 << al)) a = ((int64_t)1 << al) - 1;
  return num < 0 ? -a : a;
}

// ------------------------------------------------------------------ IDCT

const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433;
const int64_t FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633;
const int64_t FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069;
const int64_t FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t wrap16(int64_t x) { return (int64_t)(int16_t)(uint16_t)(x & 0xFFFF); }
inline int64_t sat(int64_t x, int64_t lo, int64_t hi) { return x < lo ? lo : x > hi ? hi : x; }

// one pass of the islow IDCT on v[0..7], as libjpeg-turbo's SIMD version
// computes it (jidctint.c's products regrouped, in0 +/- in4 and the odd
// part's z3, z4 summed in 16 bits), results DESCALEd by shift
inline void idct_1d(const int64_t* v, int64_t* o, int shift) {
  int64_t z2 = v[2], z3 = v[6];
  int64_t tmp2 = z2 * FIX_0_541196100 + z3 * (FIX_0_541196100 - FIX_1_847759065);
  int64_t tmp3 = z2 * (FIX_0_541196100 + FIX_0_765366865) + z3 * FIX_0_541196100;
  int64_t tmp0 = wrap16(v[0] + v[4]) * ((int64_t)1 << CONST_BITS);
  int64_t tmp1 = wrap16(v[0] - v[4]) * ((int64_t)1 << CONST_BITS);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  int64_t t0 = v[7], t1 = v[5], t2 = v[3], t3 = v[1];
  int64_t a = wrap16(t0 + t2), b = wrap16(t1 + t3);
  int64_t z3n = a * (FIX_1_175875602 - FIX_1_961570560) + b * FIX_1_175875602;
  int64_t z4n = a * FIX_1_175875602 + b * (FIX_1_175875602 - FIX_0_390180644);
  int64_t o0 = t0 * (FIX_0_298631336 - FIX_0_899976223) + t3 * -FIX_0_899976223 + z3n;
  int64_t o1 = t1 * (FIX_2_053119869 - FIX_2_562915447) + t2 * -FIX_2_562915447 + z4n;
  int64_t o2 = t1 * -FIX_2_562915447 + t2 * (FIX_3_072711026 - FIX_2_562915447) + z3n;
  int64_t o3 = t0 * -FIX_0_899976223 + t3 * (FIX_1_501321110 - FIX_0_899976223) + z4n;
  int64_t r = (int64_t)1 << (shift - 1);
  o[0] = (tmp10 + o3 + r) >> shift;
  o[7] = (tmp10 - o3 + r) >> shift;
  o[1] = (tmp11 + o2 + r) >> shift;
  o[6] = (tmp11 - o2 + r) >> shift;
  o[2] = (tmp12 + o1 + r) >> shift;
  o[5] = (tmp12 - o1 + r) >> shift;
  o[3] = (tmp13 + o0 + r) >> shift;
  o[4] = (tmp13 - o0 + r) >> shift;
}

void idct_block(const int16_t* c, const int32_t* q, uint8_t* out, int stride) {
  int64_t in[8], o[8];
  int64_t ws[64];
  bool first_row_only = true;  // the SIMD shortcut: pass 1 is row 0 << PASS1_BITS in 16 bits
  for (int i = 8; i < 64; i++) first_row_only = first_row_only && c[i] == 0;
  for (int col = 0; col < 8; col++) {
    for (int k = 0; k < 8; k++) in[k] = wrap16((int64_t)c[k * 8 + col] * wrap16(q[k * 8 + col]));
    if (first_row_only) {
      for (int k = 0; k < 8; k++) ws[k * 8 + col] = wrap16(in[0] * (1 << PASS1_BITS));
      continue;
    }
    idct_1d(in, o, CONST_BITS - PASS1_BITS);
    for (int k = 0; k < 8; k++) ws[k * 8 + col] = sat(o[k], -32768, 32767);
  }
  for (int row = 0; row < 8; row++) {
    idct_1d(ws + row * 8, o, CONST_BITS + PASS1_BITS + 3);
    for (int k = 0; k < 8; k++) out[row * stride + k] = (uint8_t)(sat(o[k], -128, 127) + 128);
  }
}

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

// jdsample.c into a (H, W) plane; in is (h, w) = the downsampled size
void upsample(const uint8_t* in, int h, int w, int in_stride, int fh, int fv, int W, int H, uint8_t* out) {
  if (fh == 1 && fv == 1) {
    for (int y = 0; y < H; y++) memcpy(out + (int64_t)y * W, in + (int64_t)y * in_stride, W);
    return;
  }
  auto px = [&](int y, int x) { return (int)in[(int64_t)clampi(y, 0, h - 1) * in_stride + clampi(x, 0, w - 1)]; };
  if (fh == 2 && fv == 1 && w > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; y++)
      for (int x = 0; x < W; x++) {
        int i = x >> 1, t = 3 * px(y, i);
        out[(int64_t)y * W + x] = (uint8_t)((x & 1) ? (t + px(y, i + 1) + 2) >> 2 : (t + px(y, i - 1) + 1) >> 2);
      }
    return;
  }
  if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int i = y >> 1;
      for (int x = 0; x < W; x++) {
        int t = 3 * px(i, x);
        out[(int64_t)y * W + x] = (uint8_t)((y & 1) ? (t + px(i + 1, x) + 2) >> 2 : (t + px(i - 1, x) + 1) >> 2);
      }
    }
    return;
  }
  if (fh == 2 && fv == 2 && w > 2) {  // h2v2_fancy_upsample
    std::vector<int> colsum(w);
    for (int y = 0; y < H; y++) {
      int i = y >> 1, nb = (y & 1) ? i + 1 : i - 1;
      for (int x = 0; x < w; x++) colsum[x] = 3 * px(i, x) + px(nb, x);
      for (int x = 0; x < W; x++) {
        int j = x >> 1, t = 3 * colsum[j];
        out[(int64_t)y * W + x] = (uint8_t)((x & 1) ? (t + colsum[clampi(j + 1, 0, w - 1)] + 7) >> 4
                                                    : (t + colsum[clampi(j - 1, 0, w - 1)] + 8) >> 4);
      }
    }
    return;
  }
  // h2v1_upsample, h2v2_upsample, int_upsample: replication
  for (int y = 0; y < H; y++)
    for (int x = 0; x < W; x++) out[(int64_t)y * W + x] = in[(int64_t)(y / fv) * in_stride + x / fh];
}

}  // namespace

extern "C" {

// plan: n_blocks rows of (scan component k, component ci, block row,
// block column, row step, column step) of one MCU; alloc_w: blocks per
// row of each component's coefficient array; coefs: each component's
// (alloc_h, alloc_w, 64) int16 array (natural order); luts: the scan
// components' DC and AC tables, 65536 int32 each.
int jpeg_decode_scan(const uint8_t* data, long long len, int n_blocks, const int* plan,
                     const int* alloc_w, int mcus_w, int mcus_h, int restart_interval,
                     const int32_t* dc_luts, const int32_t* ac_luts, int16_t** coefs) {
  Bits bits{data, (int64_t)len, 0, 0, 0, false, 0, 0};
  bits.start();
  int pred[4] = {0, 0, 0, 0};
  int64_t n_mcus = (int64_t)mcus_w * mcus_h;
  for (int64_t m = 0; m < n_mcus; m++) {
    if (restart_interval && m && m % restart_interval == 0) {
      if (!bits.restart()) return 3;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
    }
    int64_t my = m / mcus_w, mx = m % mcus_w;
    for (int b = 0; b < n_blocks; b++) {
      const int* pl = plan + 6 * b;
      int k = pl[0], ci = pl[1];
      int16_t* out = coefs[ci] + ((my * pl[4] + pl[2]) * alloc_w[ci] + mx * pl[5] + pl[3]) * 64;
      const int32_t* dl = dc_luts + (int64_t)k * 65536;
      const int32_t* al = ac_luts + (int64_t)k * 65536;
      int e = dl[bits.peek16()];
      if (e == 0) return 1;
      bits.skip(e >> 8);
      int s = e & 0xFF, r = 0;
      if (s) r = extend(bits.get(s), s);
      pred[k] += r;
      out[0] = (int16_t)pred[k];
      for (int i = 1; i < 64;) {
        e = al[bits.peek16()];
        if (e == 0) return 1;
        bits.skip(e >> 8);
        int rs = e & 0xFF;
        s = rs & 15;
        if (s) {
          i += rs >> 4;
          r = extend(bits.get(s), s);
          if (i < 64) out[kZigzag[i]] = (int16_t)r;
          i++;
        } else if (rs == 0xF0) {
          i += 16;
        } else {
          break;
        }
      }
    }
    if (bits.at_marker && bits.consumed > bits.real) return 2;
  }
  return 0;
}

// One progressive scan (jdphuff.c): plan, alloc_w and the luts as in
// jpeg_decode_scan; ss, se, ah, al the scan's band and successive
// approximation; rows_per_imcu the block rows of an iMCU row (the
// component's v in a one-component scan, else 1). *last_good: the last
// iMCU row begun before the data ran out (-1: none).
int jpeg_decode_progressive_scan(const uint8_t* data, long long len, int n_blocks, const int* plan,
                                 const int* alloc_w, int mcus_w, int mcus_h, int restart_interval, int ss,
                                 int se, int ah, int al, int rows_per_imcu, const int32_t* dc_luts,
                                 const int32_t* ac_luts, int16_t** coefs, int* last_good) {
  Bits bits{data, (int64_t)len, 0, 0, 0, false, 0, 0};
  bits.start();
  int pred[4] = {0, 0, 0, 0};
  unsigned eobrun = 0;
  bool is_short = false;  // libjpeg's insufficient_data
  const int p1 = 1 << al, m1 = -(1 << al);
  const int64_t n_mcus = (int64_t)mcus_w * mcus_h, row_mcus = (int64_t)rows_per_imcu * mcus_w;
  *last_good = -1;
  for (int64_t m = 0; m < n_mcus; m++) {
    if (restart_interval && m && m % restart_interval == 0) {
      if (bits.restart_progressive()) is_short = false;
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
    }
    if (!is_short && m % row_mcus == 0) *last_good = (int)(m / row_mcus);
    if (is_short) continue;
    int64_t my = m / mcus_w, mx = m % mcus_w;
    if (ss == 0) {
      for (int b = 0; b < n_blocks; b++) {
        const int* pl = plan + 6 * b;
        int k = pl[0], ci = pl[1];
        int16_t* out = coefs[ci] + ((my * pl[4] + pl[2]) * alloc_w[ci] + mx * pl[5] + pl[3]) * 64;
        if (ah == 0) {  // DC first: the difference, shifted by Al
          int s = progressive_symbol(bits, dc_luts + (int64_t)k * 65536);
          if (s) pred[k] += extend(bits.get(s), s);
          out[0] = (int16_t)wrap16((int64_t)pred[k] * p1);
        } else if (bits.get(1)) {  // DC refine: one bit
          out[0] = (int16_t)(out[0] | p1);
        }
      }
    } else {
      int16_t* blk = coefs[plan[1]] + (my * alloc_w[plan[1]] + mx) * 64;
      const int32_t* lut = ac_luts;
      if (ah == 0) {  // AC first, with end-of-band runs
        if (eobrun) {
          eobrun--;
        } else {
          for (int k = ss; k <= se; k++) {
            int rs = progressive_symbol(bits, lut), r = rs >> 4, s = rs & 15;
            if (s) {
              k += r;
              blk[kNatural[k]] = (int16_t)wrap16((int64_t)extend(bits.get(s), s) * p1);
            } else if (r == 15) {
              k += 15;
            } else {
              eobrun = 1u << r;
              if (r) eobrun += bits.get(r);
              eobrun--;
              break;
            }
          }
        }
      } else {  // AC refine: new coefficients of +-1 << Al, correction bits
        int k = ss;
        if (eobrun == 0) {
          for (; k <= se; k++) {
            int rs = progressive_symbol(bits, lut), r = rs >> 4, s = rs & 15;
            if (s) {
              s = bits.get(1) ? p1 : m1;
            } else if (r != 15) {
              eobrun = 1u << r;
              if (r) eobrun += bits.get(r);
              break;
            }
            do {
              int16_t* c = blk + kNatural[k];
              if (*c != 0) {
                if (bits.get(1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
              } else if (--r < 0) {
                break;
              }
              k++;
            } while (k <= se);
            if (s) blk[kNatural[k]] = (int16_t)s;
          }
        }
        if (eobrun > 0) {
          for (; k <= se; k++) {
            int16_t* c = blk + kNatural[k];
            if (*c != 0 && bits.get(1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          }
          eobrun--;
        }
      }
    }
    // the data ended inside this MCU: it is complete (zero bits), and
    // nothing more is decoded until a restart marker
    if (bits.at_marker && bits.consumed > bits.real) is_short = true;
  }
  return 0;
}

// decompress_smooth_data on one component: in and out are its (alloc_h,
// alloc_w, 64) coefficients (out a copy of in; DC neighbours are read from
// in); q its quantisation table (natural order); bits and prev_bits the
// coef_bits latches of zigzag coefficients 0..9, prev_bits used in the
// iMCU rows past last_good; total_rows the frame's iMCU rows.
int jpeg_smooth(const int16_t* in, int16_t* out, int alloc_w, int blocks_w, int blocks_h, int v, int total_rows,
                const int32_t* q, const int32_t* bits, const int32_t* prev_bits, int last_good) {
  const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  for (int imcu = 0; imcu < total_rows; imcu++) {
    int block_rows = imcu < total_rows - 1 ? v : (blocks_h % v ? blocks_h % v : v);
    int64_t n = (int64_t)block_rows * total_rows;
    const int32_t* cb = imcu > last_good ? prev_bits : bits;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && cb[k] == -1;
    for (int b = 0; b < block_rows; b++) {
      // the block rows two above to two below, as decompress_smooth_data
      // picks them (the position counts the last iMCU row's short height)
      int64_t r = (int64_t)imcu * v + b, i = (int64_t)imcu * block_rows + b;
      int64_t prev = i > 0 ? r - 1 : r, next = i < n - 1 ? r + 1 : r;
      int64_t rows[5] = {i > 1 ? r - 2 : prev, prev, r, next, i < n - 2 ? r + 2 : next};
      for (int j = 0; j < blocks_w; j++) {
        int64_t dc[25];
        for (int a = 0; a < 5; a++)
          for (int c = 0; c < 5; c++) {
            int col = j + c - 2;
            col = col < 0 ? 0 : col > blocks_w - 1 ? blocks_w - 1 : col;
            dc[a * 5 + c] = in[(rows[a] * alloc_w + col) * 64];
          }
        int16_t* ws = out + (r * alloc_w + j) * 64;
        for (int k = 1; k < (change_dc ? 10 : 6); k++) {
          if (cb[k] == 0 || ws[pos[k]] != 0) continue;
          const int* w = change_dc ? kSmoothDC[k] : kSmoothAC[k];
          int64_t num = 0;
          for (int t = 0; t < 25; t++) num += w[t] * dc[t];
          ws[pos[k]] = (int16_t)wrap16(smooth_estimate(q[0] * num, q[pos[k]], cb[k], true));
        }
        if (change_dc) {
          int64_t num = 0;
          for (int t = 0; t < 25; t++) num += kSmoothDC[0][t] * dc[t];
          ws[0] = (int16_t)wrap16(smooth_estimate(q[0] * num, q[0], 0, false));
        }
      }
    }
  }
  return 0;
}

// comp: per component (h, v, alloc_w, alloc_h, width, height); qtables:
// (ncomp, 64) natural order; color 0 gray, 1 YCbCr, 2 RGB; out (H, W, ncomp)
int jpeg_reconstruct(int ncomp, const int* comp, int16_t** coefs, const int32_t* qtables, int hmax, int vmax,
                     int W, int H, int color, uint8_t* out) {
  std::vector<std::vector<uint8_t>> full(ncomp);
  for (int c = 0; c < ncomp; c++) {
    const int* cp = comp + 6 * c;
    int h = cp[0], v = cp[1], aw = cp[2], ah = cp[3], w = cp[4], hh = cp[5];
    if (hmax % h || vmax % v) return 4;
    int stride = aw * 8;
    std::vector<uint8_t> plane((int64_t)ah * 8 * stride);
    int bh = (hh + 7) / 8, bw = (w + 7) / 8;  // only the blocks that hold samples
    for (int by = 0; by < bh; by++)
      for (int bx = 0; bx < bw; bx++)
        idct_block(coefs[c] + ((int64_t)by * aw + bx) * 64, qtables + 64 * c,
                   plane.data() + (int64_t)by * 8 * stride + bx * 8, stride);
    full[c].resize((int64_t)W * H);
    upsample(plane.data(), hh, w, stride, hmax / h, vmax / v, W, H, full[c].data());
  }
  int64_t n = (int64_t)W * H;
  if (color == 0) {
    memcpy(out, full[0].data(), n);
    return 0;
  }
  if (color == 2) {
    for (int64_t i = 0; i < n; i++)
      for (int c = 0; c < 3; c++) out[3 * i + c] = full[c][i];
    return 0;
  }
  // jdcolor.c: SCALEBITS 16, FIX(x) = x * 65536 + 0.5 rounded down
  const int64_t cr_r_f = 91881, cb_b_f = 116130, cr_g_f = 46802, cb_g_f = 22554, half = 1 << 15;
  for (int64_t i = 0; i < n; i++) {
    int y = full[0][i];
    int64_t cb = (int64_t)full[1][i] - 128, cr = (int64_t)full[2][i] - 128;
    int r = y + (int)((cr_r_f * cr + half) >> 16);
    int g = y + (int)((-cb_g_f * cb + half + -cr_g_f * cr) >> 16);
    int b = y + (int)((cb_b_f * cb + half) >> 16);
    out[3 * i] = (uint8_t)clampi(r, 0, 255);
    out[3 * i + 1] = (uint8_t)clampi(g, 0, 255);
    out[3 * i + 2] = (uint8_t)clampi(b, 0, 255);
  }
  return 0;
}

}  // extern "C"
