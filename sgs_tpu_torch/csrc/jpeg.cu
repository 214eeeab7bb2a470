// Baseline JPEG decoding on the host, equal bit for bit to PIL's
// (libjpeg-turbo's) output and to the plain version in data/jpeg.py.
//
// Host code only: nvcc's host compiler builds it into the same kind of
// ctypes library as the kernels (ops/build.py). Python parses the markers
// (data/jpeg.py::parse_jpeg) and calls, per scan, jpeg_decode_scan on the
// scan's entropy-coded bytes (stuffing and restart markers included),
// then once jpeg_reconstruct on the coefficients:
//   - Huffman decoding through 16-bit lookup tables (symbol | length << 8,
//     built in Python), DC prediction reset at each restart marker, zero
//     bits fed past a marker as libjpeg feeds them;
//   - dequantisation and jidctint.c's islow IDCT (64-bit accumulators,
//     DESCALE at the two pass outputs, the range-limit table);
//   - jdsample.c's fancy upsampling (h2v1, h1v2, h2v2 triangle filters,
//     edges replicated) or replication, and jdcolor.c's YCbCr -> RGB.
// Return codes: 0 ok, 1 a bad Huffman code, 2 the data ended inside an
// MCU, 3 a restart marker missing, 4 an unsupported sampling ratio.

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
};

inline int extend(int r, int s) { return r < (1 << (s - 1)) ? r + 1 - (1 << s) : r; }

// ------------------------------------------------------------------ IDCT

const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433;
const int64_t FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633;
const int64_t FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069;
const int64_t FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) { return (x + ((int64_t)1 << (n - 1))) >> n; }

// one jidctint.c pass on v[0..7] (stride apart), results DESCALEd by shift
inline void idct_1d(const int64_t* v, int64_t* o, int shift) {
  int64_t z2 = v[2], z3 = v[6];
  int64_t z1 = (z2 + z3) * FIX_0_541196100;
  int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
  int64_t tmp3 = z1 + z2 * FIX_0_765366865;
  int64_t tmp0 = (v[0] + v[4]) * ((int64_t)1 << CONST_BITS);
  int64_t tmp1 = (v[0] - v[4]) * ((int64_t)1 << CONST_BITS);
  int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  tmp0 = v[7];
  tmp1 = v[5];
  tmp2 = v[3];
  tmp3 = v[1];
  z1 = tmp0 + tmp3;
  z2 = tmp1 + tmp2;
  z3 = tmp0 + tmp2;
  int64_t z4 = tmp1 + tmp3;
  int64_t z5 = (z3 + z4) * FIX_1_175875602;
  tmp0 *= FIX_0_298631336;
  tmp1 *= FIX_2_053119869;
  tmp2 *= FIX_3_072711026;
  tmp3 *= FIX_1_501321110;
  z1 *= -FIX_0_899976223;
  z2 *= -FIX_2_562915447;
  z3 = z3 * -FIX_1_961570560 + z5;
  z4 = z4 * -FIX_0_390180644 + z5;
  tmp0 += z1 + z3;
  tmp1 += z2 + z4;
  tmp2 += z2 + z3;
  tmp3 += z1 + z4;
  o[0] = descale(tmp10 + tmp3, shift);
  o[7] = descale(tmp10 - tmp3, shift);
  o[1] = descale(tmp11 + tmp2, shift);
  o[6] = descale(tmp11 - tmp2, shift);
  o[2] = descale(tmp12 + tmp1, shift);
  o[5] = descale(tmp12 - tmp1, shift);
  o[3] = descale(tmp13 + tmp0, shift);
  o[4] = descale(tmp13 - tmp0, shift);
}

inline uint8_t idct_limit(int64_t x) {
  int i = (int)(x & 1023);
  return i < 128 ? (uint8_t)(i + 128) : i < 512 ? 255 : i < 896 ? 0 : (uint8_t)(i - 896);
}

void idct_block(const int16_t* c, const int32_t* q, uint8_t* out, int stride) {
  int64_t in[8], o[8];
  int64_t ws[64];
  for (int col = 0; col < 8; col++) {
    for (int k = 0; k < 8; k++) in[k] = (int64_t)c[k * 8 + col] * q[k * 8 + col];
    idct_1d(in, o, CONST_BITS - PASS1_BITS);
    for (int k = 0; k < 8; k++) ws[k * 8 + col] = (int32_t)o[k];  // wsptr is int
  }
  for (int row = 0; row < 8; row++) {
    idct_1d(ws + row * 8, o, CONST_BITS + PASS1_BITS + 3);
    for (int k = 0; k < 8; k++) out[row * stride + k] = idct_limit(o[k]);
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
