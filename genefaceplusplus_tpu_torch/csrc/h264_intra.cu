// H.264 intra encoder for Hopper (sm_90a): rendered RGB frames to the
// slices of an IDR picture, one slice per macroblock row.
//
// Replaces no TPU kernel: the JAX package encodes its mp4 outside JAX
// (libx264 through imageio, or cv2's mp4v). It was added so that the
// frames, which the renderer leaves as uint8 on the card, are encoded
// there and only the bitstream crosses the bus (tens of KB a 512^2 frame
// instead of 786 KB).
//
// It writes exactly the bytes of data/h264.py:encode_plain: Constrained
// Baseline, CAVLC, Intra 16x16 (DC or Horizontal from the left neighbour by
// SAD, DC-128 at a row's start; chroma alike), one QP, deblocking off, and
// the I_PCM escape for a macroblock whose coded bits exceed its 3,072 bits
// of samples. All arithmetic is integer, so the bytes are equal, not close.
//
// What bounds it on an H100: neither bytes nor operations. The bound is
// reading each RGB frame once and writing its bitstream (~1.6 MB for an
// 8-frame 512^2 chunk: ~0.5 us at 3.35 TB/s); the kernel's time is the
// latency of its dependent chain: a row's macroblocks follow one another,
// each predicted from the left one's reconstruction, and each costs a few
// block-wide barriers and the CAVLC of its blocks.
//
// Design:
// * One block of 256 threads per (frame, macroblock row), so an 8-frame
//   chunk of 512^2 is 256 independent blocks. Each block converts its 16
//   pixel rows from RGB to Y'CbCr 4:2:0 into shared memory first (24 bytes
//   a column: 12 KB at 512 wide, 36 KB at 1536; the opt-in limit is set
//   past 32 KB), repeating the edge pixels past the frame.
// * Per macroblock: the SAD of DC against Horizontal (a block reduction),
//   the 24 4x4 forward transforms and their quantisation (a thread a
//   block), the DC Hadamards, then the reconstruction (24 threads) beside
//   the CAVLC of the 28 bit segments (header, luma DC, 16 luma AC, 2 chroma
//   DC, 8 chroma AC; a thread a segment into its own shared buffer: every
//   nC is known once the macroblock is quantised). One thread sums the
//   segments' lengths (the prefix sum), decides the escape, and the
//   segments (or the PCM samples) are OR-ed into the row's words at their
//   offsets.
// * The row's output is the slice's RBSP (header, macroblocks, trailing
//   bits) in big-endian words, byte-swapped at the end into the byte
//   stream; its length in bits goes to `bits`. Emulation prevention and
//   the NAL and AVCC framing are done on the host over the compacted bytes
//   (data/h264.py:access_units).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SEGS = 28;
constexpr int SEG_WORDS = 24;  // 768 bits: a block's worst codable case is 641
constexpr int PCM_BITS = 384 * 8;

// CAVLC tables, (length, value) [TotalCoeff * 4 + TrailingOnes]; the same
// as data/h264.py's, which `gfpp_h264_tables` lets the wrapper compare.
__constant__ uint8_t TOKEN_LEN[4][68] = {
    {1, 0, 0, 0, 6, 2, 0, 0, 8, 6, 3, 0, 9, 8, 7, 5, 10, 9, 8, 6, 11, 10, 9, 7, 13, 11, 10, 8, 13, 13, 11, 9,
     13, 13, 13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15, 14, 16, 15, 15, 15,
     16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2, 0, 0, 0, 6, 2, 0, 0, 6, 5, 3, 0, 7, 6, 6, 4, 8, 6, 6, 4, 8, 7, 7, 5, 9, 8, 8, 6, 11, 9, 9, 6,
     11, 11, 11, 7, 12, 11, 11, 9, 12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13, 12, 13, 13, 13, 13,
     13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4, 0, 0, 0, 6, 4, 0, 0, 6, 5, 4, 0, 6, 5, 5, 4, 7, 5, 5, 4, 7, 5, 5, 4, 7, 6, 6, 4, 7, 6, 6, 4,
     8, 7, 7, 5, 8, 8, 7, 6, 9, 8, 8, 7, 9, 9, 8, 8, 9, 9, 9, 8, 10, 9, 9, 9, 10, 10, 10, 10,
     10, 10, 10, 10, 10, 10, 10, 10},
    {6, 0, 0, 0, 6, 6, 0, 0, 6, 6, 6, 0, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6,
     6, 6, 6, 6}};
__constant__ uint8_t TOKEN_BITS[4][68] = {
    {1, 0, 0, 0, 5, 1, 0, 0, 7, 4, 1, 0, 7, 6, 5, 3, 7, 6, 5, 3, 7, 6, 5, 4, 15, 6, 5, 4, 11, 14, 5, 4,
     8, 10, 13, 4, 15, 14, 9, 4, 11, 10, 13, 12, 15, 14, 9, 12, 11, 10, 13, 8, 15, 1, 9, 12,
     11, 14, 13, 8, 7, 10, 9, 12, 4, 6, 5, 8},
    {3, 0, 0, 0, 11, 2, 0, 0, 7, 7, 3, 0, 7, 10, 9, 5, 7, 6, 5, 4, 4, 6, 5, 6, 7, 6, 5, 8, 15, 6, 5, 4,
     11, 14, 13, 4, 15, 10, 9, 4, 11, 14, 13, 12, 8, 10, 9, 8, 15, 14, 13, 12, 11, 10, 9, 12,
     7, 11, 6, 8, 9, 8, 10, 1, 7, 6, 5, 4},
    {15, 0, 0, 0, 15, 14, 0, 0, 11, 15, 13, 0, 8, 12, 14, 12, 15, 10, 11, 11, 11, 8, 9, 10, 9, 14, 13, 9,
     8, 10, 9, 8, 15, 14, 13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9, 12, 8, 10, 13, 8,
     13, 7, 9, 12, 9, 12, 11, 10, 5, 8, 7, 6, 1, 4, 3, 2},
    {3, 0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
     24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47,
     48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63}};
__constant__ uint8_t DC_TOKEN_LEN[20] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6, 3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
__constant__ uint8_t DC_TOKEN_BITS[20] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6, 1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
__constant__ uint8_t TZ_LEN[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9}, {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6}, {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5}, {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6}, {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},
    {6, 4, 5, 3, 2, 2, 3, 3, 6}, {6, 6, 4, 2, 2, 3, 2, 5}, {5, 5, 3, 2, 2, 2, 4}, {4, 4, 3, 3, 1, 3},
    {4, 4, 2, 1, 3}, {3, 3, 1, 2}, {2, 2, 1}, {1, 1}};
__constant__ uint8_t TZ_BITS[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1}, {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0}, {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0}, {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0}, {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0}, {1, 0, 1, 3, 2, 1, 1, 1}, {1, 0, 1, 3, 2, 1, 1}, {0, 1, 1, 2, 1, 3},
    {0, 1, 1, 1, 1}, {0, 1, 1, 1}, {0, 1, 1}, {0, 1}};
__constant__ uint8_t DC_TZ_LEN[3][4] = {{1, 2, 3, 3}, {1, 2, 2}, {1, 1}};
__constant__ uint8_t DC_TZ_BITS[3][4] = {{1, 1, 1, 0}, {1, 1, 0}, {1, 0}};
__constant__ uint8_t RUN_LEN[7][16] = {{1, 1}, {1, 2, 2}, {2, 2, 2, 2}, {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3},
                                       {2, 3, 3, 3, 3, 3, 3}, {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11}};
__constant__ uint8_t RUN_BITS[7][16] = {{1, 0}, {1, 1, 0}, {3, 2, 1, 0}, {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0},
                                        {3, 0, 1, 3, 2, 5, 4}, {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1}};
__constant__ int MF[6][3] = {{13107, 5243, 8066}, {11916, 4660, 7490}, {10082, 4194, 6554},
                             {9362, 3647, 5825},  {8192, 3355, 5243},  {7282, 2893, 4559}};
__constant__ int V[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16}, {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
__constant__ int QPC[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
__constant__ uint8_t ZIGZAG[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
__constant__ uint8_t BLK_X[16] = {0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3};
__constant__ uint8_t BLK_Y[16] = {0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3};

__device__ __forceinline__ int pos_class(int i, int j) {
  return ((i & 1) == 0 && (j & 1) == 0) ? 0 : (((i & 1) == 1 && (j & 1) == 1) ? 1 : 2);
}
__device__ __forceinline__ int chroma_qp(int qp) { return qp < 30 ? qp : QPC[qp - 30]; }
__device__ __forceinline__ int quant(int w, int mf, int qbits, int off) {
  int q = (abs(w) * mf + off) >> qbits;
  return w < 0 ? -q : q;
}
__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

// A bit writer into zeroed big-endian words that only this thread touches.
struct Bits {
  uint32_t* w;
  int n;
  __device__ void put(uint32_t v, int len) {  // the low `len` (<= 32) bits of v
    if (len == 0) return;
    int word = n >> 5, off = n & 31;
    if (off + len <= 32) {
      w[word] |= v << (32 - off - len);
    } else {
      w[word] |= v >> (off + len - 32);
      w[word + 1] |= v << (64 - off - len);
    }
    n += len;
  }
  __device__ void ue(uint32_t v) {
    uint32_t code = v + 1;
    int len = 32 - __clz(code);
    put(code, 2 * len - 1);
  }
};

// OR `len` bits (<= 32, left-aligned in v) into the row's words at bit `pos`.
__device__ __forceinline__ void or_bits(uint32_t* row, int pos, uint32_t v) {
  int q = pos >> 5, off = pos & 31;
  atomicOr(row + q, v >> off);
  if (off) atomicOr(row + q + 1, v << (32 - off));
}

// CAVLC residual_block() of `c` (max_coeff levels in scan order); nc -1 is
// the 4:2:0 chroma DC. Returns false where a level is too large for
// Baseline's level_prefix <= 15 (the macroblock then takes the escape).
__device__ bool residual_block(Bits& b, const int* c, int max_coeff, int nc) {
  int nz[16], tc = 0;
  for (int i = 0; i < max_coeff; ++i)
    if (c[i]) nz[tc++] = i;
  int table = nc < 0 ? -1 : (nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3)));
  int t1 = 0;
  while (t1 < 3 && t1 < tc && (c[nz[tc - 1 - t1]] == 1 || c[nz[tc - 1 - t1]] == -1)) ++t1;
  int idx = tc * 4 + t1;
  if (table < 0)
    b.put(DC_TOKEN_BITS[idx], DC_TOKEN_LEN[idx]);
  else
    b.put(TOKEN_BITS[table][idx], TOKEN_LEN[table][idx]);
  if (tc == 0) return true;
  for (int k = 0; k < t1; ++k) b.put(c[nz[tc - 1 - k]] < 0 ? 1 : 0, 1);
  int suffix_len = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int k = t1; k < tc; ++k) {
    int level = c[nz[tc - 1 - k]];
    int code = level > 0 ? 2 * level - 2 : -2 * level - 1;
    if (k == t1 && t1 < 3) code -= 2;
    if (suffix_len == 0) {
      if (code < 14) {
        b.put(1, code + 1);
      } else if (code < 30) {
        b.put(1, 15);
        b.put(code - 14, 4);
      } else if (code < 30 + 4096) {
        b.put(1, 16);
        b.put(code - 30, 12);
      } else {
        return false;
      }
    } else if (code < (15 << suffix_len)) {
      b.put(1, (code >> suffix_len) + 1);
      b.put(code & ((1 << suffix_len) - 1), suffix_len);
    } else if (code - (15 << suffix_len) < 4096) {
      b.put(1, 16);
      b.put(code - (15 << suffix_len), 12);
    } else {
      return false;
    }
    if (suffix_len == 0) suffix_len = 1;
    if (abs(level) > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
  }
  int total_zeros = nz[tc - 1] + 1 - tc;
  if (tc < max_coeff) {
    if (table < 0)
      b.put(DC_TZ_BITS[tc - 1][total_zeros], DC_TZ_LEN[tc - 1][total_zeros]);
    else
      b.put(TZ_BITS[tc - 1][total_zeros], TZ_LEN[tc - 1][total_zeros]);
  }
  int zeros_left = total_zeros;
  for (int k = 0; k < tc - 1 && zeros_left > 0; ++k) {
    int run = nz[tc - 1 - k] - nz[tc - 2 - k] - 1;
    int t = (zeros_left < 7 ? zeros_left : 7) - 1;
    b.put(RUN_BITS[t][run], RUN_LEN[t][run]);
    zeros_left -= run;
  }
  return true;
}

__device__ __forceinline__ void fwd1(int& a, int& b, int& c, int& d) {
  int s03 = a + d, d03 = a - d, s12 = b + c, d12 = b - c;
  a = s03 + s12;
  b = 2 * d03 + d12;
  c = s03 - s12;
  d = d03 - 2 * d12;
}
__device__ __forceinline__ void inv1(int& a, int& b, int& c, int& d) {
  int e0 = a + c, e1 = a - c, e2 = (b >> 1) - d, e3 = b + (d >> 1);
  a = e0 + e3;
  b = e1 + e2;
  c = e1 - e2;
  d = e0 - e3;
}
__device__ void forward4x4(int* x) {  // x[i * 4 + j], row i = y
  for (int i = 0; i < 4; ++i) fwd1(x[i * 4], x[i * 4 + 1], x[i * 4 + 2], x[i * 4 + 3]);
  for (int j = 0; j < 4; ++j) fwd1(x[j], x[4 + j], x[8 + j], x[12 + j]);
}
__device__ void inverse4x4(int* d) {
  for (int i = 0; i < 4; ++i) inv1(d[i * 4], d[i * 4 + 1], d[i * 4 + 2], d[i * 4 + 3]);
  for (int j = 0; j < 4; ++j) inv1(d[j], d[4 + j], d[8 + j], d[12 + j]);
  for (int k = 0; k < 16; ++k) d[k] = (d[k] + 32) >> 6;
}
__device__ __forceinline__ void had1(int& a, int& b, int& c, int& d) {
  int p = a + b, q = a - b, r = c + d, s = c - d;
  a = p + r;
  b = p - r;
  c = q - s;
  d = q + s;
}
__device__ void hadamard4(int* x) {
  for (int i = 0; i < 4; ++i) had1(x[i * 4], x[i * 4 + 1], x[i * 4 + 2], x[i * 4 + 3]);
  for (int j = 0; j < 4; ++j) had1(x[j], x[4 + j], x[8 + j], x[12 + j]);
}
__device__ __forceinline__ void hadamard2(int* x) {
  int a = x[0], b = x[1], c = x[2], d = x[3];
  x[0] = a + b + c + d;
  x[1] = a - b + c - d;
  x[2] = a + b - c - d;
  x[3] = a - b - c + d;
}
__device__ __forceinline__ int scale_ac(int c, int qp, int i, int j) {
  int ls = 16 * V[qp % 6][pos_class(i, j)], q = qp / 6;
  return q >= 4 ? (c * ls) << (q - 4) : (c * ls + (1 << (3 - q))) >> (4 - q);
}

__device__ int nc_of(int na, int nb) {  // -1: not available
  if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
  return na >= 0 ? na : (nb >= 0 ? nb : 0);
}

__global__ void __launch_bounds__(THREADS) h264_intra_kernel(const uint8_t* __restrict__ rgb, int H, int W,
                                                             int mbh, int mbw, int first_index, int qp,
                                                             uint32_t* __restrict__ out, int row_words,
                                                             int* __restrict__ out_bits) {
  extern __shared__ uint8_t smem[];
  const int Wp = mbw * 16, Wc = mbw * 8;
  uint8_t* Ys = smem;                // [16][Wp]
  uint8_t* Cs = smem + 16 * Wp;      // [2][8][Wc]
  __shared__ int wy[16][16];         // luma coefficients, block raster by * 4 + bx
  __shared__ int wc[2][4][16];       // chroma coefficients, block raster by * 2 + bx
  __shared__ int dcy[16], dcc[2][4];  // quantised DC levels (raster), then their reconstruction
  __shared__ int recdcy[16], recdcc[2][4];
  __shared__ uint8_t rec_y[256], rec_c[2][64];
  __shared__ int nnz_y[16], nnz_c[2][4];
  __shared__ int left_y[16], left_c[2][8], left_nnz_y[4], left_nnz_c[2][2];
  __shared__ uint32_t seg_words[SEGS][SEG_WORDS];
  __shared__ int seg_bits[SEGS], seg_off[SEGS];
  __shared__ int red[THREADS / 32][4];
  __shared__ int s_mode_h, s_cmode_h, s_dcy, s_dcc[2][2], s_cbp_luma, s_cbp_chroma, s_bad, s_escape;
  __shared__ int s_pos, s_start, s_pcm_at;

  const int t = threadIdx.x;
  const int slice = blockIdx.x, frame = slice / mbh, row = slice % mbh;
  uint32_t* rowp = out + (size_t)slice * row_words;
  const int qpc = chroma_qp(qp);
  const int qbits = 15 + qp / 6, qbits_c = 15 + qpc / 6;

  // the row's words zeroed; its 16 pixel rows to Y'CbCr 4:2:0, edges repeated
  for (int i = t; i < row_words; i += THREADS) rowp[i] = 0u;
  const uint8_t* src = rgb + (size_t)frame * H * W * 3;
  for (int q = t; q < 8 * Wc; q += THREADS) {
    int qy = q / Wc, qx = q % Wc;
    int rs = 0, gs = 0, bs = 0;
    for (int dy = 0; dy < 2; ++dy)
      for (int dx = 0; dx < 2; ++dx) {
        int y = min(row * 16 + 2 * qy + dy, H - 1), x = min(2 * qx + dx, W - 1);
        const uint8_t* p = src + ((size_t)y * W + x) * 3;
        int r = p[0], g = p[1], b = p[2];
        Ys[(2 * qy + dy) * Wp + 2 * qx + dx] = (uint8_t)(((66 * r + 129 * g + 25 * b + 128) >> 8) + 16);
        rs += r;
        gs += g;
        bs += b;
      }
    Cs[qy * Wc + qx] = (uint8_t)(((-38 * rs - 74 * gs + 112 * bs + 512) >> 10) + 128);
    Cs[8 * Wc + qy * Wc + qx] = (uint8_t)(((112 * rs - 94 * gs - 18 * bs + 512) >> 10) + 128);
  }
  __syncthreads();  // the row's words are zero before any bit is OR-ed in
  if (t == 0) {
    // slice_header(): first_mb_in_slice, slice_type 7, pps 0, frame_num 0,
    // idr_pic_id, dec_ref_pic_marking, slice_qp_delta, deblocking off (1)
    Bits b{seg_words[0], 0};
    for (int i = 0; i < SEG_WORDS; ++i) seg_words[0][i] = 0u;
    b.ue(row * mbw);
    b.ue(7);
    b.ue(0);
    b.put(0, 4);
    b.ue((first_index + frame) & 1);
    b.put(0, 2);
    int d = qp - 26;
    b.ue(d > 0 ? 2 * d - 1 : -2 * d);
    b.ue(1);
    for (int i = 0; i * 32 < b.n; ++i) or_bits(rowp, 32 * i, seg_words[0][i]);
    s_pos = b.n;
    for (int i = 0; i < 4; ++i) left_nnz_y[i] = -1;
    for (int i = 0; i < 4; ++i) left_nnz_c[i / 2][i % 2] = -1;
  }
  __syncthreads();

  for (int mx = 0; mx < mbw; ++mx) {
    // 1. prediction modes: SAD of DC against Horizontal from the left column
    if (mx > 0) {
      int sum = 0;
      for (int i = 0; i < 16; ++i) sum += left_y[i];
      const int dc = (sum + 8) >> 4;
      int v[4] = {0, 0, 0, 0};
      {
        int y = t / 16, x = t % 16, s = Ys[y * Wp + 16 * mx + x];
        v[0] = abs(s - dc);
        v[1] = abs(s - left_y[y]);
      }
      if (t < 128) {
        int c = t / 64, cy = (t % 64) / 8, cx = t % 8, h = (cy / 4) * 4;
        int s = Cs[c * 8 * Wc + cy * Wc + 8 * mx + cx];
        int cdc = (left_c[c][h] + left_c[c][h + 1] + left_c[c][h + 2] + left_c[c][h + 3] + 2) >> 2;
        v[2] = abs(s - cdc);
        v[3] = abs(s - left_c[c][cy]);
      }
      for (int k = 0; k < 4; ++k)
        for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
      if (t % 32 == 0)
        for (int k = 0; k < 4; ++k) red[t / 32][k] = v[k];
      if (t == 0) {
        s_dcy = dc;
        for (int c = 0; c < 2; ++c)
          for (int h = 0; h < 2; ++h)
            s_dcc[c][h] = (left_c[c][4 * h] + left_c[c][4 * h + 1] + left_c[c][4 * h + 2] + left_c[c][4 * h + 3] + 2) >> 2;
      }
      __syncthreads();
      if (t == 0) {
        int s[4] = {0, 0, 0, 0};
        for (int w = 0; w < THREADS / 32; ++w)
          for (int k = 0; k < 4; ++k) s[k] += red[w][k];
        s_mode_h = s[1] < s[0];
        s_cmode_h = s[3] < s[2];
      }
    } else if (t == 0) {
      s_mode_h = s_cmode_h = 0;
      s_dcy = 128;
      s_dcc[0][0] = s_dcc[0][1] = s_dcc[1][0] = s_dcc[1][1] = 128;
    }
    __syncthreads();
    const bool mode_h = s_mode_h, cmode_h = s_cmode_h;

    // 2. residual, forward transform, AC quantisation: a thread a 4x4 block
    if (t < 24) {
      int x[16];
      if (t < 16) {
        int by = t / 4, bx = t % 4;
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) {
            int y = 4 * by + i;
            int pred = mx == 0 ? 128 : (mode_h ? left_y[y] : s_dcy);
            x[i * 4 + j] = Ys[y * Wp + 16 * mx + 4 * bx + j] - pred;
          }
      } else {
        int c = (t - 16) / 4, k = (t - 16) % 4, by = k / 2, bx = k % 2;
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) {
            int y = 4 * by + i;
            int pred = mx == 0 ? 128 : (cmode_h ? left_c[c][y] : s_dcc[c][by]);
            x[i * 4 + j] = Cs[c * 8 * Wc + y * Wc + 8 * mx + 4 * bx + j] - pred;
          }
      }
      forward4x4(x);
      const int q = t < 16 ? qp : qpc, qb = t < 16 ? qbits : qbits_c;
      int* dst = t < 16 ? wy[t] : wc[(t - 16) / 4][(t - 16) % 4];
      int n = 0;
      dst[0] = x[0];  // the DC, quantised through the Hadamard below
      for (int k = 1; k < 16; ++k) {
        dst[k] = quant(x[k], MF[q % 6][pos_class(k / 4, k % 4)], qb, (1 << qb) / 3);
        n += dst[k] != 0;
      }
      if (t < 16)
        nnz_y[t] = n;
      else
        nnz_c[(t - 16) / 4][(t - 16) % 4] = n;
    }
    __syncthreads();

    // 3. the DC transforms: luma by thread 0, each chroma component by 1, 2
    if (t == 0) {
      int d[16];
      for (int k = 0; k < 16; ++k) d[k] = wy[k][0];
      hadamard4(d);
      for (int k = 0; k < 16; ++k) d[k] = quant(d[k] >> 1, MF[qp % 6][0], qbits + 1, (1 << (qbits + 1)) / 3);
      for (int k = 0; k < 16; ++k) dcy[k] = d[k];
      hadamard4(d);
      const int ls = 16 * V[qp % 6][0], q6 = qp / 6;
      for (int k = 0; k < 16; ++k)
        recdcy[k] = q6 >= 6 ? (d[k] * ls) << (q6 - 6) : (d[k] * ls + (1 << (5 - q6))) >> (6 - q6);
    } else if (t < 3) {
      const int c = t - 1;
      int d[4];
      for (int k = 0; k < 4; ++k) d[k] = wc[c][k][0];
      hadamard2(d);
      for (int k = 0; k < 4; ++k) {
        d[k] = quant(d[k], MF[qpc % 6][0], qbits_c + 1, (1 << (qbits_c + 1)) / 3);
        dcc[c][k] = d[k];
      }
      hadamard2(d);
      for (int k = 0; k < 4; ++k) recdcc[c][k] = ((d[k] * (16 * V[qpc % 6][0])) << (qpc / 6)) >> 5;
    }
    __syncthreads();
    if (t == 0) {
      int any_y = 0, any_cac = 0, any_cdc = 0;
      for (int k = 0; k < 16; ++k) any_y |= nnz_y[k];
      for (int k = 0; k < 8; ++k) {
        any_cac |= nnz_c[k / 4][k % 4];
        any_cdc |= dcc[k / 4][k % 4];
      }
      s_cbp_luma = any_y ? 15 : 0;
      s_cbp_chroma = any_cac ? 2 : (any_cdc ? 1 : 0);
      s_bad = 0;
    }
    __syncthreads();

    // 4. reconstruction (threads 0..23) beside the CAVLC (threads 32..59)
    if (t < 24) {
      int d[16];
      if (t < 16) {
        int by = t / 4, bx = t % 4;
        for (int k = 1; k < 16; ++k) d[k] = scale_ac(wy[t][k], qp, k / 4, k % 4);
        d[0] = recdcy[t];
        inverse4x4(d);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) {
            int y = 4 * by + i;
            int pred = mx == 0 ? 128 : (mode_h ? left_y[y] : s_dcy);
            rec_y[y * 16 + 4 * bx + j] = (uint8_t)clip255(pred + d[i * 4 + j]);
          }
      } else {
        int c = (t - 16) / 4, k = (t - 16) % 4, by = k / 2, bx = k % 2;
        for (int m = 1; m < 16; ++m) d[m] = scale_ac(wc[c][k][m], qpc, m / 4, m % 4);
        d[0] = recdcc[c][k];
        inverse4x4(d);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) {
            int y = 4 * by + i;
            int pred = mx == 0 ? 128 : (cmode_h ? left_c[c][y] : s_dcc[c][by]);
            rec_c[c][y * 8 + 4 * bx + j] = (uint8_t)clip255(pred + d[i * 4 + j]);
          }
      }
    } else if (t >= 32 && t < 32 + SEGS) {
      const int s = t - 32;
      for (int i = 0; i < SEG_WORDS; ++i) seg_words[s][i] = 0u;
      Bits b{seg_words[s], 0};
      const int cbp_l = s_cbp_luma, cbp_c = s_cbp_chroma;
      int c[16];
      bool ok = true;
      if (s == 0) {
        b.ue(1 + (mode_h ? 1 : 2) + 4 * cbp_c + (cbp_l ? 12 : 0));
        b.ue(cmode_h ? 1 : 0);
        b.put(1, 1);  // mb_qp_delta 0
      } else if (s == 1) {
        for (int i = 0; i < 16; ++i) c[i] = dcy[ZIGZAG[i]];
        ok = residual_block(b, c, 16, nc_of(mx > 0 ? left_nnz_y[0] : -1, -1));
      } else if (s < 18) {
        if (cbp_l) {
          const int blk = s - 2, bx = BLK_X[blk], by = BLK_Y[blk];
          for (int i = 0; i < 15; ++i) c[i] = wy[by * 4 + bx][ZIGZAG[i + 1]];
          int na = bx > 0 ? nnz_y[by * 4 + bx - 1] : (mx > 0 ? left_nnz_y[by] : -1);
          int nb = by > 0 ? nnz_y[(by - 1) * 4 + bx] : -1;
          ok = residual_block(b, c, 15, nc_of(na, nb));
        }
      } else if (s < 20) {
        if (cbp_c) {
          for (int i = 0; i < 4; ++i) c[i] = dcc[s - 18][i];
          ok = residual_block(b, c, 4, -1);
        }
      } else if (cbp_c == 2) {
        const int cc = (s - 20) / 4, k = (s - 20) % 4, by = k / 2, bx = k % 2;
        for (int i = 0; i < 15; ++i) c[i] = wc[cc][k][ZIGZAG[i + 1]];
        int na = bx > 0 ? nnz_c[cc][by * 2] : (mx > 0 ? left_nnz_c[cc][by] : -1);
        int nb = by > 0 ? nnz_c[cc][bx] : -1;
        ok = residual_block(b, c, 15, nc_of(na, nb));
      }
      seg_bits[s] = b.n;
      if (!ok) s_bad = 1;
    }
    __syncthreads();

    // 5. the segments' offsets, and the I_PCM escape
    if (t == 0) {
      int total = 0;
      for (int s = 0; s < SEGS; ++s) {
        seg_off[s] = total;
        total += seg_bits[s];
      }
      const int start = s_pos;
      s_start = start;
      s_escape = s_bad || total > PCM_BITS;
      if (s_escape) {
        s_pcm_at = (start + 9 + 7) / 8 * 8;
        total = s_pcm_at + PCM_BITS - start;
      }
      s_pos = start + total;
    }
    __syncthreads();

    // 6. the macroblock's bits into the row; the left column and totals
    const bool esc = s_escape;
    if (!esc) {
      if (t < SEGS)
        for (int i = 0; i * 32 < seg_bits[t]; ++i) or_bits(rowp, s_start + seg_off[t] + 32 * i, seg_words[t][i]);
    } else {
      if (t == 0) or_bits(rowp, s_start, 26u << 23);  // ue(25): 0000 11010
      if (t < 96) {
        uint32_t w = 0;
        for (int k = 0; k < 4; ++k) {
          int i = 4 * t + k, v;
          if (i < 256)
            v = Ys[(i / 16) * Wp + 16 * mx + i % 16];
          else
            v = Cs[((i - 256) / 64) * 8 * Wc + (((i - 256) % 64) / 8) * Wc + 8 * mx + (i - 256) % 8];
          w = (w << 8) | (uint32_t)v;
        }
        or_bits(rowp, s_pcm_at + 32 * t, w);
      }
    }
    if (t >= 128 && t < 144) {
      int y = t - 128;
      left_y[y] = esc ? Ys[y * Wp + 16 * mx + 15] : rec_y[y * 16 + 15];
    } else if (t >= 160 && t < 176) {
      int c = (t - 160) / 8, y = (t - 160) % 8;
      left_c[c][y] = esc ? Cs[c * 8 * Wc + y * Wc + 8 * mx + 7] : rec_c[c][y * 8 + 7];
    } else if (t == 192) {
      for (int y = 0; y < 4; ++y) left_nnz_y[y] = esc ? 16 : nnz_y[y * 4 + 3];
      for (int c = 0; c < 2; ++c)
        for (int y = 0; y < 2; ++y) left_nnz_c[c][y] = esc ? 16 : nnz_c[c][y * 2 + 1];
    }
    __syncthreads();
  }

  // rbsp_slice_trailing_bits, then the words into the byte stream
  if (t == 0) {
    or_bits(rowp, s_pos, 1u << 31);
    out_bits[slice] = (s_pos + 1 + 7) / 8 * 8;
  }
  __syncthreads();
  const int used = (s_pos + 1 + 31) / 32;
  for (int i = t; i < used; i += THREADS) rowp[i] = __byte_perm(rowp[i], 0, 0x0123);
}

}  // namespace

extern "C" {

// frames [B, H, W, 3] uint8 RGB (contiguous) -> out [B * mb_rows, row_words]
// 32-bit words (each slice's RBSP as bytes, zero padded) and bits [B * mb_rows].
int gfpp_h264_intra(const uint8_t* rgb, int B, int H, int W, int first_index, int qp, uint32_t* out,
                    int row_words, int* bits, cudaStream_t stream) {
  const int mbh = (H + 15) / 16, mbw = (W + 15) / 16;
  const int smem = 24 * mbw * 16;
  if (smem > 32 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(h264_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  h264_intra_kernel<<<B * mbh, THREADS, smem, stream>>>(rgb, H, W, mbh, mbw, first_index, qp, out, row_words, bits);
  return (int)cudaGetLastError();
}

// The tables the kernel was built with, flattened as data/h264.py's
// kernel_tables() flattens its own; returns the count written.
int gfpp_h264_tables(int* dst, int n) {
  uint8_t tl[4][68], tb[4][68], dl[20], db[20], zl[15][16], zb[15][16], cl[3][4], cb[3][4], rl[7][16], rb[7][16];
  int mf[6][3], v[6][3], qpc[22];
  uint8_t zz[16], bx[16], by[16];
  cudaMemcpyFromSymbol(tl, TOKEN_LEN, sizeof(tl));
  cudaMemcpyFromSymbol(tb, TOKEN_BITS, sizeof(tb));
  cudaMemcpyFromSymbol(dl, DC_TOKEN_LEN, sizeof(dl));
  cudaMemcpyFromSymbol(db, DC_TOKEN_BITS, sizeof(db));
  cudaMemcpyFromSymbol(zl, TZ_LEN, sizeof(zl));
  cudaMemcpyFromSymbol(zb, TZ_BITS, sizeof(zb));
  cudaMemcpyFromSymbol(cl, DC_TZ_LEN, sizeof(cl));
  cudaMemcpyFromSymbol(cb, DC_TZ_BITS, sizeof(cb));
  cudaMemcpyFromSymbol(rl, RUN_LEN, sizeof(rl));
  cudaMemcpyFromSymbol(rb, RUN_BITS, sizeof(rb));
  cudaMemcpyFromSymbol(mf, MF, sizeof(mf));
  cudaMemcpyFromSymbol(v, V, sizeof(v));
  cudaMemcpyFromSymbol(qpc, QPC, sizeof(qpc));
  cudaMemcpyFromSymbol(zz, ZIGZAG, sizeof(zz));
  cudaMemcpyFromSymbol(bx, BLK_X, sizeof(bx));
  cudaMemcpyFromSymbol(by, BLK_Y, sizeof(by));
  if (cudaGetLastError() != cudaSuccess) return -1;
  int k = 0;
  auto put = [&](int x) {
    if (k < n) dst[k] = x;
    ++k;
  };
  for (auto& r : tl) for (int x : r) put(x);
  for (auto& r : tb) for (int x : r) put(x);
  for (int x : dl) put(x);
  for (int x : db) put(x);
  for (auto& r : zl) for (int x : r) put(x);
  for (auto& r : zb) for (int x : r) put(x);
  for (auto& r : cl) for (int x : r) put(x);
  for (auto& r : cb) for (int x : r) put(x);
  for (auto& r : rl) for (int x : r) put(x);
  for (auto& r : rb) for (int x : r) put(x);
  for (auto& r : mf) for (int x : r) put(x);
  for (auto& r : v) for (int x : r) put(x);
  for (int x : qpc) put(x);
  for (int x : zz) put(x);
  for (int x : bx) put(x);
  for (int x : by) put(x);
  return k;
}

const char* gfpp_cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
