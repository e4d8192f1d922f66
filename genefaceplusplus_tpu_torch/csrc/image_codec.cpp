// Host-side image codec for the dataset's image files (no CUDA): the PNG
// unfilter, a baseline JPEG decoder and a baseline JPEG encoder, each with
// the integer arithmetic of libjpeg-turbo as OpenCV calls it, so a decode
// equals cv2.imread's bit for bit:
//   decode  jidctint.c's ISLOW IDCT with its range-limit table; jdsample.c's
//           fancy upsampling (h2v1, h2v2; box upsampling when the chroma is
//           at most 2 samples wide, as jinit_upsampler picks); jdcolor.c's
//           integer YCbCr -> RGB tables;
//   encode  at cv2.imwrite's defaults (quality 95, 4:2:0): jccolor.c's
//           integer RGB -> YCbCr, jcsample.c's h2v2 downsample,
//           jfdctint.c's ISLOW FDCT, jcdctmgr.c's reciprocal quantisation,
//           the Annex K tables scaled by jpeg_quality_scaling, jcmarker.c's
//           marker layout (JFIF APP0, DQT, SOF0, DHT, SOS) and jccoefct.c's
//           dummy blocks at the right and bottom edges.
// Built at first use with the host compiler (data/image_io.py) and called
// through ctypes. Every entry returns 0 on success; on failure it returns -1
// and writes a message naming the unsupported feature or the fault into
// `err`. Right shifts of negative values go through `asr`, whose result the
// language defines, so every compiler gives the same bytes.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

inline int64_t asr(int64_t x, int n) { return x >= 0 ? x >> n : ~((~x) >> n); }
inline int64_t descale(int64_t x, int n) { return asr(x + (int64_t(1) << (n - 1)), n); }
inline int clamp255(int64_t v) { return v < 0 ? 0 : (v > 255 ? 255 : int(v)); }

struct Fail {
  char msg[200];
};

[[noreturn]] void fail(const char* fmt, int a = 0, int b = 0) {
  Fail f;
  std::snprintf(f.msg, sizeof f.msg, fmt, a, b);
  throw f;
}

void set_err(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

// jpeg_natural_order, with 16 extra entries so a corrupt run cannot index
// past the block (as libjpeg's table)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- the DCTs

constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                  F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                  F2_562 = 20995, F3_072 = 25172;

// jdmaster.c's prepare_range_limit_table, as the IDCT indexes it:
// out = table[v & 1023] for the descaled value v
struct IdctLimit {
  uint8_t t[1024];
  IdctLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = i < 128 ? uint8_t(i + 128) : i < 512 ? 255 : i < 896 ? 0 : uint8_t(i - 896);
  }
};
const IdctLimit kIdctLimit;

// jidctint.c: jpeg_idct_islow; coef in natural order, q the dequantisation
// multipliers in natural order; 8x8 samples to out (row stride `stride`)
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    int64_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int64_t dc = int64_t(in[0]) * qp[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qp[16], z3 = int64_t(in[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    z2 = int64_t(in[0]) * qp[0];
    z3 = int64_t(in[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS), tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * qp[56];
    tmp1 = int64_t(in[40]) * qp[40];
    tmp2 = int64_t(in[24]) * qp[24];
    tmp3 = int64_t(in[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 = z3 * -F1_961 + z5;
    z4 = z4 * -F0_390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS - PASS1_BITS;
    w[0] = descale(tmp10 + tmp3, S);
    w[56] = descale(tmp10 - tmp3, S);
    w[8] = descale(tmp11 + tmp2, S);
    w[48] = descale(tmp11 - tmp2, S);
    w[16] = descale(tmp12 + tmp1, S);
    w[40] = descale(tmp12 - tmp1, S);
    w[24] = descale(tmp13 + tmp0, S);
    w[32] = descale(tmp13 - tmp0, S);
  }
  const uint8_t* lim = kIdctLimit.t;
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + size_t(r) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = lim[descale(w[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847, tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS), tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 = z3 * -F1_961 + z5;
    z4 = z4 * -F0_390 + z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int S = CONST_BITS + PASS1_BITS + 3;
    o[0] = lim[descale(tmp10 + tmp3, S) & 1023];
    o[7] = lim[descale(tmp10 - tmp3, S) & 1023];
    o[1] = lim[descale(tmp11 + tmp2, S) & 1023];
    o[6] = lim[descale(tmp11 - tmp2, S) & 1023];
    o[2] = lim[descale(tmp12 + tmp1, S) & 1023];
    o[5] = lim[descale(tmp12 - tmp1, S) & 1023];
    o[3] = lim[descale(tmp13 + tmp0, S) & 1023];
    o[4] = lim[descale(tmp13 - tmp0, S) & 1023];
  }
}

// jfdctint.c: jpeg_fdct_islow on samples - 128, in place (results scaled
// up by 8, as jcdctmgr.c's divisors expect)
void fdct_islow(int32_t* d) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    for (int i = 0; i < 8; ++i) {
      int32_t* p = d + i * stride;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int S = pass == 0 ? CONST_BITS - PASS1_BITS : CONST_BITS + PASS1_BITS;
      if (pass == 0) {
        p[0] = int32_t((tmp10 + tmp11) * (1 << PASS1_BITS));
        p[4 * step] = int32_t((tmp10 - tmp11) * (1 << PASS1_BITS));
      } else {
        p[0] = int32_t(descale(tmp10 + tmp11, PASS1_BITS));
        p[4 * step] = int32_t(descale(tmp10 - tmp11, PASS1_BITS));
      }
      int64_t z1 = (tmp12 + tmp13) * F0_541;
      p[2 * step] = int32_t(descale(z1 + tmp13 * F0_765, S));
      p[6 * step] = int32_t(descale(z1 + tmp12 * -F1_847, S));
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1_175;
      tmp4 *= F0_298;
      tmp5 *= F2_053;
      tmp6 *= F3_072;
      tmp7 *= F1_501;
      z1 *= -F0_899;
      z2 *= -F2_562;
      z3 = z3 * -F1_961 + z5;
      z4 = z4 * -F0_390 + z5;
      p[7 * step] = int32_t(descale(tmp4 + z1 + z3, S));
      p[5 * step] = int32_t(descale(tmp5 + z2 + z4, S));
      p[3 * step] = int32_t(descale(tmp6 + z2 + z3, S));
      p[step] = int32_t(descale(tmp7 + z1 + z4, S));
    }
  }
}

// ---------------------------------------------------------------- colour

constexpr int SCALEBITS = 16;
constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
constexpr int64_t fix(double x) { return int64_t(x * (1 << SCALEBITS) + 0.5); }

// jdcolor.c: build_ycc_rgb_table
struct YccRgb {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccRgb() {
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int(asr(fix(1.40200) * x + ONE_HALF, SCALEBITS));
      cb_b[i] = int(asr(fix(1.77200) * x + ONE_HALF, SCALEBITS));
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const YccRgb kYcc;

// jccolor.c: rgb_ycc_start's table
struct RgbYcc {
  int64_t t[8][256];  // R_Y G_Y B_Y R_CB G_CB B_CB(=R_CR) G_CR B_CR
  RgbYcc() {
    const int64_t cbcr_offset = int64_t(128) << SCALEBITS;
    for (int i = 0; i < 256; ++i) {
      t[0][i] = fix(0.29900) * i;
      t[1][i] = fix(0.58700) * i;
      t[2][i] = fix(0.11400) * i + ONE_HALF;
      t[3][i] = -fix(0.16874) * i;
      t[4][i] = -fix(0.33126) * i;
      t[5][i] = fix(0.50000) * i + cbcr_offset + ONE_HALF - 1;
      t[6][i] = -fix(0.41869) * i;
      t[7][i] = -fix(0.08131) * i;
    }
  }
};
const RgbYcc kRgb;

// ---------------------------------------------------------------- Huffman

struct HuffDec {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18], valoff[17];
  uint16_t fast[512];  // 9-bit lookahead: (length << 8) | symbol, 0 = slow path
};

// jdhuff.c: jpeg_make_d_derived_tbl's checks, canonical codes
void build_dec(HuffDec& h, const uint8_t* counts, const uint8_t* vals, int n, bool dc) {
  std::memcpy(h.vals, vals, size_t(n));
  int code = 0, k = 0;
  std::memset(h.fast, 0, sizeof h.fast);
  for (int l = 1; l <= 16; ++l) {
    h.valoff[l] = k - code;
    for (int i = 0; i < counts[l - 1]; ++i, ++k, ++code) {
      // no code may be all ones (jdhuff.c), so each fits in l bits and its
      // lookahead entries in `fast`
      if (code + 1 >= (1 << l)) fail("bad Huffman table (code lengths overflow)");
      if (l <= 9)
        for (int j = 0; j < 1 << (9 - l); ++j) h.fast[(code << (9 - l)) | j] = uint16_t((l << 8) | vals[k]);
    }
    h.maxcode[l] = counts[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  if (dc)
    for (int i = 0; i < n; ++i)
      if (vals[i] > 15) fail("bad Huffman table (DC symbol %d)", vals[i]);
  h.defined = true;
}

struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0, fake = 0;  // bits held; of them, zero bits past the data
  int marker = -1;        // the marker that stopped the reads

  void fill() {
    while (cnt <= 56) {
      int b = 0;
      if (marker < 0 && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          size_t p = pos + 1;
          while (p < n && d[p] == 0xFF) ++p;
          if (p >= n) {
            pos = n;
            marker = 0x100;  // the data ends inside a marker
            b = -1;
          } else if (d[p] == 0) {
            pos = p + 1;
          } else {
            marker = d[p];
            pos = p + 1;
            b = -1;
          }
        } else {
          ++pos;
        }
      } else {
        b = -1;
      }
      if (b < 0) {
        buf <<= 8;
        cnt += 8;
        fake += 8;
      } else {
        buf = (buf << 8) | uint64_t(b);
        cnt += 8;
      }
    }
  }
  void consume(int k) {
    if (k > cnt - fake) fail("truncated or corrupt entropy-coded data");
    cnt -= k;
  }
  int peek(int k) {
    if (cnt < k) fill();
    return int((buf >> (cnt - k)) & ((uint64_t(1) << k) - 1));
  }
  int bits(int k) {
    if (k == 0) return 0;
    int v = peek(k);
    consume(k);
    return v;
  }
  int decode(const HuffDec& h) {
    int p = peek(16);
    int f = h.fast[p >> 7];
    if (f) {
      consume(f >> 8);
      return f & 0xFF;
    }
    for (int l = 10; l <= 16; ++l) {
      int code = p >> (16 - l);
      if (code <= h.maxcode[l]) {
        consume(l);
        return h.vals[h.valoff[l] + code];
      }
    }
    fail("corrupt entropy-coded data (bad Huffman code)");
  }
  // jdhuff.c: HUFF_EXTEND
  int receive_extend(int s) {
    if (s == 0) return 0;
    int x = bits(s);
    return x < (1 << (s - 1)) ? x - ((1 << s) - 1) : x;
  }
  void restart(int expect) {
    cnt = fake = 0;
    buf = 0;
    if (marker < 0) {
      while (pos < n && d[pos] != 0xFF) ++pos;  // the padding ends the segment
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) fail("truncated data (a restart marker is missing)");
      marker = d[pos++];
    }
    if (marker != 0xD0 + expect) fail("restart marker RST%d missing (found 0x%02X)", expect, marker);
    marker = -1;
  }
};

// ---------------------------------------------------------------- decoder

struct Component {
  int id, h, v, tq, td = 0, ta = 0;
  int bw, bh;  // blocks across the MCU grid
  std::vector<uint8_t> plane;
  int pred = 0;
};

struct Jpeg {
  const uint8_t* d;
  size_t n;
  uint16_t q[4][64];
  bool qdef[4] = {false, false, false, false};
  HuffDec dc[4], ac[4];
  int H = 0, W = 0, restart = 0, hmax = 1, vmax = 1;
  bool adobe_rgb = false, have_frame = false;
  Component comp[3];

  int u16(size_t p) {
    if (p + 2 > n) fail("truncated data (in a marker segment)");
    return (d[p] << 8) | d[p + 1];
  }

  void dqt(size_t p, size_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      ++p;
      if (tq > 3 || pq > 1) fail("bad DQT (table %d, precision %d)", tq, pq);
      if (p + size_t(64) * (pq + 1) > end) fail("truncated DQT");
      for (int i = 0; i < 64; ++i, p += pq + 1)
        q[tq][kNatural[i]] = uint16_t(pq ? (d[p] << 8) | d[p + 1] : d[p]);
      qdef[tq] = true;
    }
  }

  void dht(size_t p, size_t end) {
    while (p < end) {
      if (p + 17 > end) fail("truncated DHT");
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("bad DHT (class %d, table %d)", tc, th);
      const uint8_t* counts = d + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || p + 17 + size_t(total) > end) fail("bad DHT (%d symbols)", total);
      build_dec(tc ? ac[th] : dc[th], counts, d + p + 17, total, tc == 0);
      p += 17 + size_t(total);
    }
  }

  void sof(int marker, size_t p, size_t end) {
    if (have_frame) fail("a second frame header (SOF)");
    if (marker == 0xC2 || marker == 0xC6 || marker == 0xCA || marker == 0xCE) fail("progressive JPEG");
    if (marker == 0xC3 || marker == 0xC7 || marker == 0xCB || marker == 0xCF) fail("lossless JPEG");
    if (marker == 0xC5) fail("hierarchical JPEG");
    if (marker >= 0xC9) fail("arithmetic-coded JPEG");
    if (end - p < 6) fail("truncated SOF");
    if (d[p] != 8) fail("%d-bit JPEG (only 8-bit samples)", d[p]);
    H = u16(p + 1);
    W = u16(p + 3);
    int nc = d[p + 5];
    if (nc == 1) fail("grayscale JPEG (1 component)");
    if (nc == 4) fail("CMYK/YCCK JPEG (4 components)");
    if (nc != 3) fail("JPEG with %d components", nc);
    if (H == 0 || W == 0) fail("JPEG without a height or width (DNL)");
    if (end - p < size_t(6 + 3 * nc)) fail("truncated SOF");
    for (int i = 0; i < 3; ++i) {
      const uint8_t* c = d + p + 6 + 3 * i;
      comp[i].id = c[0];
      comp[i].h = c[1] >> 4;
      comp[i].v = c[1] & 15;
      comp[i].tq = c[2];
      if (comp[i].tq > 3) fail("bad quantisation table number %d", comp[i].tq);
    }
    hmax = comp[0].h;
    vmax = comp[0].v;
    bool ok = comp[1].h == 1 && comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1 &&
              ((hmax == 1 && vmax == 1) || (hmax == 2 && vmax == 1) || (hmax == 2 && vmax == 2));
    if (!ok)
      fail("chroma sampling %dx%d (only 4:4:4, 4:2:2 h2v1 and 4:2:0 h2v2)", comp[0].h * 10 + comp[0].v,
           comp[1].h * 10 + comp[1].v);
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B') fail("RGB-coded JPEG (no YCbCr)");
    have_frame = true;
  }

  void scan(size_t p, size_t end) {
    int ns = d[p];
    if (ns != 3) fail("non-interleaved scan (%d of 3 components)", ns);
    if (end - p < size_t(4 + 2 * ns)) fail("truncated SOS");
    Component* order[3];
    for (int i = 0; i < 3; ++i) {
      int id = d[p + 1 + 2 * i];
      order[i] = nullptr;
      for (auto& c : comp)
        if (c.id == id) order[i] = &c;
      if (!order[i]) fail("scan names component %d, not in the frame", id);
      order[i]->td = d[p + 2 + 2 * i] >> 4;
      order[i]->ta = d[p + 2 + 2 * i] & 15;
      if (order[i]->td > 3 || order[i]->ta > 3) fail("bad Huffman table number");
    }
    if (order[0] != &comp[0] || order[1] != &comp[1] || order[2] != &comp[2])
      fail("scan order differs from the frame's");
    int ss = d[p + 7], se = d[p + 8], ahal = d[p + 9];
    if (ss != 0 || se != 63 || ahal != 0) fail("not a sequential scan (Ss %d, Se %d)", ss, se);
    for (auto& c : comp) {
      if (!dc[c.td].defined || !ac[c.ta].defined) fail("scan uses an undefined Huffman table");
      if (!qdef[c.tq]) fail("frame uses an undefined quantisation table %d", c.tq);
    }
    const int mcux = (W + 8 * hmax - 1) / (8 * hmax), mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comp) {
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.plane.assign(size_t(c.bw) * 8 * size_t(c.bh) * 8, 0);
      c.pred = 0;
    }
    BitReader br{d, n, end};
    int16_t blk[64];
    const int total = mcux * mcuy;
    int rst = 0;
    for (int m = 0; m < total; ++m) {
      if (restart && m > 0 && m % restart == 0) {
        br.restart(rst);
        rst = (rst + 1) & 7;
        for (auto& c : comp) c.pred = 0;
      }
      const int mx = m % mcux, my = m / mcux;
      for (auto& c : comp) {
        const int stride = c.bw * 8;
        for (int by = 0; by < c.v; ++by)
          for (int bx = 0; bx < c.h; ++bx) {
            std::memset(blk, 0, sizeof blk);
            int s = br.decode(dc[c.td]);
            c.pred += br.receive_extend(s);
            blk[0] = int16_t(c.pred);
            const HuffDec& a = ac[c.ta];
            for (int k = 1; k < 64; ++k) {
              int rs = br.decode(a);
              int r = rs >> 4;
              s = rs & 15;
              if (s) {
                k += r;
                blk[kNatural[k]] = int16_t(br.receive_extend(s));
              } else {
                if (r != 15) break;
                k += 15;
              }
            }
            const size_t x0 = size_t(mx * c.h + bx) * 8, y0 = size_t(my * c.v + by) * 8;
            idct_islow(blk, q[c.tq], c.plane.data() + y0 * stride + x0, stride);
          }
      }
    }
  }

  // the headers up to the first scan; returns the scan header's offset
  size_t headers() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI)");
    size_t p = 2;
    for (;;) {
      while (p < n && d[p] != 0xFF) ++p;  // libjpeg skips garbage with a warning
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n) fail("truncated data (no scan)");
      int marker = d[p++];
      if (marker == 0xD8 || (marker >= 0xD0 && marker <= 0xD7) || marker == 0x01) continue;
      if (marker == 0xD9) fail("truncated data (EOI before a scan)");
      int len = u16(p);
      if (len < 2 || p + size_t(len) > n) fail("truncated data (in a marker segment)");
      size_t body = p + 2, end = p + size_t(len);
      if (marker == 0xDB) {
        dqt(body, end);
      } else if (marker == 0xC4) {
        dht(body, end);
      } else if (marker == 0xDD) {
        if (len < 4) fail("bad DRI");
        restart = u16(body);
      } else if (marker == 0xCC) {
        fail("arithmetic-coded JPEG");
      } else if (marker >= 0xC0 && marker <= 0xCF) {
        sof(marker, body, end);
      } else if (marker == 0xDA) {
        if (len < 3) fail("bad SOS");
        return body;
      } else if (marker == 0xEE && len >= 14 && std::memcmp(d + body, "Adobe", 5) == 0) {
        adobe_rgb = d[body + 11] == 0;  // transform 0: the components are not YCbCr
      }
      p = end;
    }
  }

  void to_rgb(uint8_t* out) {
    if (adobe_rgb) fail("RGB-coded JPEG (Adobe transform 0)");
    const Component &y = comp[0], &cb = comp[1], &cr = comp[2];
    const int ys = y.bw * 8, cs = cb.bw * 8;
    const int dw = (W + hmax - 1) / hmax, dh = (H + vmax - 1) / vmax;  // downsampled size
    const bool fancy = hmax == 1 || dw > 2;
    std::vector<uint8_t> ucb(size_t(2) * dw + 2), ucr(size_t(2) * dw + 2);
    std::vector<int> sb(size_t(dw) + 1), sr(size_t(dw) + 1);
    for (int r = 0; r < H; ++r) {
      const uint8_t *pcb, *pcr;
      if (hmax == 1) {
        pcb = cb.plane.data() + size_t(r) * cs;
        pcr = cr.plane.data() + size_t(r) * cs;
      } else {
        const int cy = vmax == 2 ? r >> 1 : r;
        for (int k = 0; k < 2; ++k) {
          const uint8_t* in = (k ? cr : cb).plane.data() + size_t(cy) * cs;
          uint8_t* o = (k ? ucr : ucb).data();
          if (!fancy) {  // h2v1_upsample / h2v2_upsample
            for (int c = 0; c < dw; ++c) o[2 * c] = o[2 * c + 1] = in[c];
          } else if (vmax == 1) {  // h2v1_fancy_upsample
            o[0] = in[0];
            o[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
            for (int c = 1; c < dw - 1; ++c) {
              int v = in[c] * 3;
              o[2 * c] = uint8_t((v + in[c - 1] + 1) >> 2);
              o[2 * c + 1] = uint8_t((v + in[c + 1] + 2) >> 2);
            }
            const int c = dw - 1;
            o[2 * c] = uint8_t((in[c] * 3 + in[c - 1] + 1) >> 2);
            o[2 * c + 1] = in[c];
          } else {  // h2v2_fancy_upsample; context rows clamp at the image's top and bottom
            const int ny = (r & 1) ? (cy + 1 < dh ? cy + 1 : dh - 1) : (cy > 0 ? cy - 1 : 0);
            const uint8_t* in1 = (k ? cr : cb).plane.data() + size_t(ny) * cs;
            std::vector<int>& s = k ? sr : sb;
            for (int c = 0; c < dw; ++c) s[c] = in[c] * 3 + in1[c];
            o[0] = uint8_t((s[0] * 4 + 8) >> 4);
            o[1] = uint8_t((s[0] * 3 + s[1] + 7) >> 4);
            for (int c = 1; c < dw - 1; ++c) {
              o[2 * c] = uint8_t((s[c] * 3 + s[c - 1] + 8) >> 4);
              o[2 * c + 1] = uint8_t((s[c] * 3 + s[c + 1] + 7) >> 4);
            }
            const int c = dw - 1;
            o[2 * c] = uint8_t((s[c] * 3 + s[c - 1] + 8) >> 4);
            o[2 * c + 1] = uint8_t((s[c] * 4 + 7) >> 4);
          }
        }
        pcb = ucb.data();
        pcr = ucr.data();
      }
      const uint8_t* py = y.plane.data() + size_t(r) * ys;
      uint8_t* o = out + size_t(r) * W * 3;
      for (int c = 0; c < W; ++c) {  // jdcolor.c: ycc_rgb_convert
        const int yy = py[c], b = pcb[c], rr = pcr[c];
        o[3 * c] = uint8_t(clamp255(yy + kYcc.cr_r[rr]));
        o[3 * c + 1] = uint8_t(clamp255(yy + asr(kYcc.cb_g[b] + kYcc.cr_g[rr], SCALEBITS)));
        o[3 * c + 2] = uint8_t(clamp255(yy + kYcc.cb_b[b]));
      }
    }
  }
};

// ---------------------------------------------------------------- encoder

// jcparam.c: std_luminance_quant_tbl / std_chrominance_quant_tbl (natural order)
const uint16_t kStdQuant[2][64] = {
    {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
     14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
     18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99},
    {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
     99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
     99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99}};

// jstdhuff.c: the Annex K tables; counts for lengths 1..16, then symbols
const uint8_t kDcLumCounts[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrCounts[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumCounts[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrCounts[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffEnc {
  uint32_t code[256];
  uint8_t len[256];
  HuffEnc(const uint8_t* counts, const uint8_t* vals) {
    std::memset(len, 0, sizeof len);
    uint32_t c = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l, c <<= 1)
      for (int i = 0; i < counts[l - 1]; ++i, ++k, ++c) {
        code[vals[k]] = c;
        len[vals[k]] = uint8_t(l);
      }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    buf = (buf << n) | (bits & ((uint64_t(1) << n) - 1));
    cnt += n;
    while (cnt >= 8) {
      uint8_t b = uint8_t(buf >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
  void flush() {  // jchuff.c: flush_bits pads the last byte with 1 bits
    if (cnt) put((1u << (8 - cnt)) - 1, 8 - cnt);
  }
};

int nbits(int v) {
  int a = v < 0 ? -v : v, n = 0;
  while (a) {
    ++n;
    a >>= 1;
  }
  return n;
}

// jcdctmgr.c: compute_reciprocal (16-bit DCTELEM) and quantize
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor, fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  return {uint32_t(fq), c, r};
}

// cv2.imwrite's defaults: quality 95, 4:2:0 (h2v2) sampling
constexpr int kQuality = 95;

struct Encoder {
  int H, W;
  uint16_t qt[2][64];
  Divisor div[2][64];
  HuffEnc dcl{kDcLumCounts, kDcVals}, dcc{kDcChrCounts, kDcVals};
  HuffEnc acl{kAcLumCounts, kAcLumVals}, acc{kAcChrCounts, kAcChrVals};

  Encoder(int h, int w) : H(h), W(w) {
    // jcparam.c: jpeg_quality_scaling, jpeg_add_quant_table with force_baseline
    const int scale = 200 - kQuality * 2;
    for (int t = 0; t < 2; ++t)
      for (int i = 0; i < 64; ++i) {
        long v = (long(kStdQuant[t][i]) * scale + 50L) / 100L;
        if (v <= 0) v = 1;
        if (v > 255) v = 255;
        qt[t][i] = uint16_t(v);
        div[t][i] = reciprocal(uint32_t(v) << 3);
      }
  }

  // samples of one 8x8 block from an edge-expanded plane -> quantised coefs
  void block(const uint8_t* plane, int stride, int x0, int y0, int t, int16_t* coef) {
    int32_t d[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) d[8 * r + c] = int32_t(plane[size_t(y0 + r) * stride + x0 + c]) - 128;
    fdct_islow(d);
    for (int i = 0; i < 64; ++i) {
      const Divisor& v = div[t][i];
      int64_t x = d[i];
      uint64_t a = uint64_t(x < 0 ? -x : x);
      int64_t qv = int64_t(((a + v.corr) * v.recip) >> v.shift);
      coef[i] = int16_t(x < 0 ? -qv : qv);
    }
  }

  // jchuff.c: encode_one_block
  void emit(BitWriter& bw, const int16_t* coef, int& pred, const HuffEnc& dc, const HuffEnc& ac) {
    int diff = coef[0] - pred;
    pred = coef[0];
    int nb = nbits(diff);
    bw.put(dc.code[nb], dc.len[nb]);
    if (nb) bw.put(uint32_t(diff < 0 ? diff - 1 : diff), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = coef[kNatural[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac.code[0xF0], ac.len[0xF0]);
        run -= 16;
      }
      nb = nbits(v);
      const int sym = (run << 4) + nb;
      bw.put(ac.code[sym], ac.len[sym]);
      bw.put(uint32_t(v < 0 ? v - 1 : v), nb);
      run = 0;
    }
    if (run > 0) bw.put(ac.code[0], ac.len[0]);
  }

  static void marker(std::vector<uint8_t>& o, int m, int len) {
    o.push_back(0xFF);
    o.push_back(uint8_t(m));
    o.push_back(uint8_t(len >> 8));
    o.push_back(uint8_t(len & 255));
  }

  static void dht(std::vector<uint8_t>& o, int index, const uint8_t* counts, const uint8_t* vals) {
    int total = 0;
    for (int i = 0; i < 16; ++i) total += counts[i];
    marker(o, 0xC4, 2 + 1 + 16 + total);
    o.push_back(uint8_t(index));
    o.insert(o.end(), counts, counts + 16);
    o.insert(o.end(), vals, vals + total);
  }

  void headers(std::vector<uint8_t>& o) {
    const uint8_t soi_jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J',  'F',  'I',  'F',
                                0x00, 0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    o.insert(o.end(), soi_jfif, soi_jfif + sizeof soi_jfif);
    for (int t = 0; t < 2; ++t) {  // jcmarker.c: emit_dqt, one marker per table
      marker(o, 0xDB, 67);
      o.push_back(uint8_t(t));
      for (int i = 0; i < 64; ++i) o.push_back(uint8_t(qt[t][kNatural[i]]));
    }
    marker(o, 0xC0, 17);
    const uint8_t sof[] = {8, uint8_t(H >> 8), uint8_t(H & 255), uint8_t(W >> 8), uint8_t(W & 255), 3, 1, 0x22, 0,
                           2, 0x11,            1,                3,               0x11,             1};
    o.insert(o.end(), sof, sof + sizeof sof);
    dht(o, 0x00, kDcLumCounts, kDcVals);
    dht(o, 0x10, kAcLumCounts, kAcLumVals);
    dht(o, 0x01, kDcChrCounts, kDcVals);
    dht(o, 0x11, kAcChrCounts, kAcChrVals);
    marker(o, 0xDA, 12);
    const uint8_t sos[] = {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    o.insert(o.end(), sos, sos + sizeof sos);
  }

  void encode(const uint8_t* rgb, std::vector<uint8_t>& o) {
    headers(o);
    const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
    // jccolor.c: rgb_ycc_convert; then edge-expanded planes as jcprepct.c and
    // jcsample.c pad them (last column and row replicated)
    const int pw = mcux * 16, ph = mcuy * 16;
    std::vector<uint8_t> planes[3];
    for (auto& p : planes) p.resize(size_t(pw) * ph);
    for (int r = 0; r < ph; ++r) {
      const uint8_t* in = rgb + size_t(r < H ? r : H - 1) * W * 3;
      for (int c = 0; c < pw; ++c) {
        const uint8_t* px = in + 3 * size_t(c < W ? c : W - 1);
        const int R = px[0], G = px[1], B = px[2];
        const size_t i = size_t(r) * pw + c;
        planes[0][i] = uint8_t((kRgb.t[0][R] + kRgb.t[1][G] + kRgb.t[2][B]) >> SCALEBITS);
        planes[1][i] = uint8_t((kRgb.t[3][R] + kRgb.t[4][G] + kRgb.t[5][B]) >> SCALEBITS);
        planes[2][i] = uint8_t((kRgb.t[5][R] + kRgb.t[6][G] + kRgb.t[7][B]) >> SCALEBITS);
      }
    }
    // jcsample.c: h2v2_downsample, bias 1, 2, 1, 2, ... along each row
    std::vector<uint8_t> chroma[2];
    const int cw = pw / 2, ch = ph / 2, dh = (H + 1) / 2;  // chroma row stride, rows, real rows
    for (int k = 0; k < 2; ++k) {
      chroma[k].resize(size_t(cw) * ch);
      const std::vector<uint8_t>& p = planes[1 + k];
      for (int r = 0; r < ch; ++r) {
        // rows past the image's downsampled height repeat its last one
        const int rr = r < dh ? r : dh - 1;
        const uint8_t *a = p.data() + size_t(2 * rr) * pw, *b = a + pw;
        uint8_t* out = chroma[k].data() + size_t(r) * cw;
        for (int c = 0, bias = 1; c < cw; ++c, bias ^= 3)
          out[c] = uint8_t((a[2 * c] + a[2 * c + 1] + b[2 * c] + b[2 * c + 1] + bias) >> 2);
      }
    }
    BitWriter bw(o);
    int pred[3] = {0, 0, 0};
    int16_t coef[64];
    const int ybw = (W + 7) / 8, ybh = (H + 7) / 8;  // Y's real blocks
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        // jccoefct.c: blocks past Y's real ones are dummies: zero AC, the DC
        // of the block before them in the MCU
        int16_t ydc[4];
        for (int by = 0; by < 2; ++by)
          for (int bx = 0; bx < 2; ++bx) {
            const int gx = mx * 2 + bx, gy = my * 2 + by, i = by * 2 + bx;
            if (gy >= ybh) {
              std::memset(coef, 0, sizeof coef);
              coef[0] = ydc[by * 2 - 1];
            } else if (gx >= ybw) {
              std::memset(coef, 0, sizeof coef);
              coef[0] = ydc[i - 1];
            } else {
              block(planes[0].data(), pw, gx * 8, gy * 8, 0, coef);
            }
            ydc[i] = coef[0];
            emit(bw, coef, pred[0], dcl, acl);
          }
        for (int k = 0; k < 2; ++k) {
          block(chroma[k].data(), cw, mx * 8, my * 8, 1, coef);
          emit(bw, coef, pred[1 + k], dcc, acc);
        }
      }
    bw.flush();
    o.push_back(0xFF);
    o.push_back(0xD9);
  }
};

}  // namespace

extern "C" {

// PNG: undo the row filters of 8-bit rows, `bpp` bytes a pixel. src holds
// h rows of (1 filter byte + w * bpp) bytes; dst gets h * w * bpp bytes.
int gf_png_unfilter(const uint8_t* src, int64_t src_len, uint8_t* dst, int h, int w, int bpp, char* err,
                    int errlen) {
  const int64_t row = int64_t(w) * bpp;
  if (src_len != h * (row + 1)) {
    set_err(err, errlen, "image data size differs from the header's (truncated or corrupt)");
    return -1;
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* s = src + y * (row + 1);
    const int ft = s[0];
    ++s;
    uint8_t* o = dst + y * row;
    const uint8_t* up = y ? o - row : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(o, s, size_t(row));
        break;
      case 1:
        for (int64_t i = 0; i < row; ++i) o[i] = uint8_t(s[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < row; ++i) o[i] = uint8_t(s[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < row; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0;
          o[i] = uint8_t(s[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < row; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0, b = up ? up[i] : 0, c = (up && i >= bpp) ? up[i - bpp] : 0;
          const int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
                    pc = p > c ? p - c : c - p;
          o[i] = uint8_t(s[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default: {
        char m[80];
        std::snprintf(m, sizeof m, "bad PNG filter type %d in row %d", ft, y);
        set_err(err, errlen, m);
        return -1;
      }
    }
  }
  return 0;
}

// Baseline JPEG -> uint8 [H, W, 3] RGB. dims gets (H, W); with `out` null
// or `cap` below H * W * 3 it returns 1 after the headers.
int gf_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                   int errlen) {
  try {
    Jpeg j;
    j.d = data;
    j.n = size_t(len);
    size_t sos = j.headers();
    if (!j.have_frame) fail("a scan before the frame header");
    dims[0] = j.H;
    dims[1] = j.W;
    if (!out || cap < int64_t(j.H) * j.W * 3) return 1;
    size_t end = sos + size_t(j.u16(sos - 2)) - 2;
    j.scan(sos, end);
    j.to_rgb(out);
    return 0;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return -1;
  }
}

// uint8 [H, W, 3] RGB -> baseline JPEG (the standard tables at quality 95,
// 4:2:0). Returns the length written to out, or -1.
int64_t gf_jpeg_encode(const uint8_t* rgb, int h, int w, uint8_t* out, int64_t cap, char* err, int errlen) {
  try {
    if (h <= 0 || w <= 0 || h > 65535 || w > 65535) fail("JPEG size %dx%d out of range", w, h);
    std::vector<uint8_t> o;
    o.reserve(size_t(h) * w);
    Encoder(h, w).encode(rgb, o);
    if (int64_t(o.size()) > cap) fail("output buffer too small");
    std::memcpy(out, o.data(), o.size());
    return int64_t(o.size());
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return -1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return -1;
  }
}

}  // extern "C"
