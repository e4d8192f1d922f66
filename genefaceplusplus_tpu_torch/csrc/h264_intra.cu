// H.264 intra encoder for Hopper (sm_90a): rendered RGB frames to the NAL
// units of an IDR picture, one slice per macroblock row.
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
// Each slice leaves the kernel as the NAL unit the file holds: the 4-byte
// AVCC length, the header byte 0x65 and the slice's RBSP with emulation
// prevention (data/h264.py:frame_slices is the plain version of that step).
//
// What bounds it on an H100: neither bytes nor operations. The bound is
// reading each RGB frame once and writing its bitstream (~1.6 MB for an
// 8-frame 512^2 chunk: ~0.5 us at 3.35 TB/s); the kernel's time is the
// latency of its dependent chain: a row's macroblocks follow one another,
// each predicted from the left one's reconstruction. The design keeps that
// chain to one warp and everything else off it.
//
// Design, one block of 256 threads per (frame, macroblock row):
// * Pre-pass (all threads): the row's 16 pixel rows to Y'CbCr 4:2:0 in
//   shared memory, edges repeated past the frame (24 bytes a column).
// * The chain (warp 0, warp-synchronous: shuffles and warp reductions, no
//   block barrier): per macroblock each lane of 24 takes its source block's
//   forward 4x4 transform before the mode is known (the core transform is
//   exactly linear, so the prediction's transform is subtracted after: the
//   DC term for DC prediction and DC-128 at a row's start, the first
//   coefficient column for Horizontal), then the mode SADs (__vsadu4 and
//   one redux each for luma and chroma), the quantisation (a lane a
//   block), both DC Hadamards by shuffles, the length-only CAVLC of the 28
//   segments (a lane a segment, levels in registers, no branch, the tables
//   in shared memory), the I_PCM decision (a redux of the lengths), and the
//   reconstruction of only the right-hand 4x4 column that the next
//   macroblock predicts from. It hands each macroblock over through a ring
//   of RING slots in shared memory (its levels, modes, nC, segment lengths
//   and first bit), with an mbarrier a slot each way.
// * Consumers (warps 1..CONSUMERS, every CONSUMERS-th macroblock each):
//   wait on the slot, scan the segment lengths into offsets and write each
//   segment from its own lane at its offset (or the I_PCM samples) into
//   the row's words in shared memory by atomic OR, then free the slot. The
//   chain waits only for a slot RING macroblocks old.
// * Framing (all threads): the stop bit, then the NAL unit: emulation
//   prevention puts 0x03 before a byte <= 3
//   that follows an even run of two or more zero bytes (what
//   data/h264.py:emulation_prevention's scan does), found by a block
//   max-scan of each thread's last non-zero byte and placed by a block
//   sum-scan of the insertions, staged in the ring's and pixels' dead
//   shared memory and copied out in 16-byte stores. The wrapper compacts
//   the units with one gather and one copy to the host.
// Shared memory is ~1 KB a macroblock column and 14 KB of ring: two
// blocks an SM up to 1536 wide (--debug panels). Past the card's shared
// memory a block (3,808 wide on an H100) the second instantiation keeps the
// row's words in the block's own row of `units`, past the unit's bound, and
// frames straight into that row: the same code on global memory, up to
// ~9,000 wide, where the pixels and the ring alone fill shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CONSUMERS = 7;  // warps 1..CONSUMERS write the finished macroblocks
constexpr int SEGS = 28;
constexpr int PCM_BITS = 384 * 8;
constexpr int NBLK = 24;     // 4x4 blocks a macroblock: 16 luma (raster by * 4 + bx), 4 Cb, 4 Cr
constexpr int RING = 16;     // macroblocks handed over and not yet written, at most
constexpr int ROW_PAD = 4;   // bytes past each pixel row in shared memory: the chain's rows on other banks
constexpr unsigned FULL = 0xffffffffu;
static_assert(CONSUMERS < WARPS, "warp 0 runs the chain");

// CAVLC tables, (length, value) [TotalCoeff * 4 + TrailingOnes]; the same
// as data/h264.py's, which `gfpp_h264_tables` lets the wrapper compare.
// The kernel copies them to shared memory: lanes index them divergently.
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

// ZIGZAG as a constant expression for the chain's unrolled loops, a nibble
// a scan position (gfpp_h264_tables checks it against ZIGZAG)
constexpr uint64_t ZIGZAG_NIBBLES = 0xFEB7ADC963258410ull;
__host__ __device__ constexpr int zigzag(int i) { return (int)((ZIGZAG_NIBBLES >> (4 * i)) & 15); }
// the quantiser class of raster position k (row k / 4, column k % 4)
__host__ __device__ constexpr int pos_class(int k) {
  return ((k >> 2) & 1) == 0 && (k & 1) == 0 ? 0 : (((k >> 2) & 1) == 1 && (k & 1) == 1 ? 1 : 2);
}

// The record of one macroblock that the chain hands to a consumer. `len`
// and `nc` by the chain's lane: 0..15 luma AC (raster), 16..23 chroma AC
// (16 + c * 4 + by * 2 + bx), 24 luma DC, 25 and 26 chroma DC, 27 the
// macroblock's header.
struct Meta {
  int start;  // the macroblock's first bit in the slice
  int flags;  // MODE_H | CMODE_H | CBP_LUMA | cbp_chroma << 3 | ESCAPE
  uint16_t len[32];
  int8_t nc[32];
};
constexpr int MODE_H = 1, CMODE_H = 2, CBP_LUMA = 4, ESCAPE = 32;

struct Slot {            // a macroblock handed over: its levels [coefficient][block] and record
  int16_t lev[16][NBLK];  // slot 0 of each block: the DC levels (luma raster, chroma 16 + c * 4 + k)
  Meta meta;
};

struct Tables {
  uint8_t tok_len[4][68], tok_bits[4][68], dc_len[20], dc_bits[20], tz_len[15][16], tz_bits[15][16];
  uint8_t dctz_len[3][4], dctz_bits[3][4], run_len[7][16], run_bits[7][16], zigzag[16];
  uint8_t seg_lane[SEGS];  // segment s of the bitstream -> the chain's lane
};

// Byte offsets of the dynamic shared memory (all 16-byte aligned). The
// ring and the pixels are dead once the row's macroblocks are written: the
// framing stages the NAL unit from `ring` to `words`, so that region is at
// least the unit's bound (the mbarriers before it stay untouched). Without
// `shared_words` the words and the unit are in global memory: the layout
// ends with the pixels.
struct Layout {
  int full, empty, ring, y, c, words, ys, cs, bytes;
};
__host__ __device__ inline int up16(int n) { return (n + 15) & ~15; }
__host__ __device__ inline Layout layout(int mbw, int row_words, bool shared_words) {
  Layout l;
  l.ys = 16 * mbw + ROW_PAD;
  l.cs = 8 * mbw + ROW_PAD;
  l.full = 0;                                   // a ring slot's mbarrier: handed over
  l.empty = 8 * RING;                           // and written
  l.ring = 16 * RING;                           // Slot [RING]
  l.y = up16(l.ring + (int)sizeof(Slot) * RING);  // Y [16][ys]
  l.c = l.y + 16 * l.ys;                        // Cb, Cr [2][8][cs]
  if (!shared_words) {
    l.words = -1;
    l.bytes = up16(l.c + 16 * l.cs);
    return l;
  }
  const int unit = 5 + 4 * row_words * 3 / 2;   // the NAL unit's bound: emulation prevention adds a byte in two
  l.words = up16(l.c + 16 * l.cs > l.ring + unit ? l.c + 16 * l.cs : l.ring + unit);  // the slice's RBSP, big-endian words
  l.bytes = l.words + 4 * row_words;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(1) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// returns once the barrier's phase of this parity has completed; traps
// (the launch fails) rather than hang if it never does
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ int quant(int w, int mf, int qbits, int off) {
  int q = (abs(w) * mf + off) >> qbits;
  return w < 0 ? -q : q;
}
__device__ __forceinline__ int clip255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
__device__ __forceinline__ int ue_len(int v) { return 2 * (31 - __clz(v + 1)) + 1; }
__device__ __forceinline__ int nc_of(int na, int nb) {  // -1: not available
  if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
  return na >= 0 ? na : (nb >= 0 ? nb : 0);
}
__device__ __forceinline__ void fwd1(int& a, int& b, int& c, int& d) {
  int s03 = a + d, d03 = a - d, s12 = b + c, d12 = b - c;
  a = s03 + s12;
  b = 2 * d03 + d12;
  c = s03 - s12;
  d = d03 - 2 * d12;
}
__device__ void forward4x4(int* x) {  // x[i * 4 + j], row i = y
#pragma unroll
  for (int i = 0; i < 4; ++i) fwd1(x[i * 4], x[i * 4 + 1], x[i * 4 + 2], x[i * 4 + 3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) fwd1(x[j], x[4 + j], x[8 + j], x[12 + j]);
}
// element j of the Hadamard butterfly of (a, b, c, d): the 4x4 one's rows
// and columns; the 2x2 one over a 2x2 block in raster order
__device__ __forceinline__ int had4(int a, int b, int c, int d, int j) {
  const int p = a + b, q = a - b, r = c + d, s = c - d;
  return j == 0 ? p + r : (j == 1 ? p - r : (j == 2 ? q - s : q + s));
}
__device__ __forceinline__ int had2(int a, int b, int c, int d, int j) {
  return j == 0 ? a + b + c + d : (j == 1 ? a - b + c - d : (j == 2 ? a + b - c - d : a - b - c + d));
}
// The 4x4 Hadamard of the luma lanes' values (lane = raster index) or the
// 2x2 of each chroma component's four lanes, by shuffles over the warp.
__device__ __forceinline__ int dc_transform(int v, bool luma) {
  const int lane = threadIdx.x & 31, base = lane & ~3, j = lane & 3;
  const int a = __shfl_sync(FULL, v, base), b = __shfl_sync(FULL, v, base + 1);
  const int c = __shfl_sync(FULL, v, base + 2), d = __shfl_sync(FULL, v, base + 3);
  const int row = had4(a, b, c, d, j), h2 = had2(a, b, c, d, j);
  const int a2 = __shfl_sync(FULL, row, j), b2 = __shfl_sync(FULL, row, j + 4);
  const int c2 = __shfl_sync(FULL, row, j + 8), d2 = __shfl_sync(FULL, row, j + 12);
  return luma ? had4(a2, b2, c2, d2, (lane >> 2) & 3) : h2;
}

// A bit writer at any bit of the row's big-endian words; words shared with
// another segment are OR-ed in atomically.
struct Writer {
  uint32_t* w;
  int word, n;   // the next word to write, the bits pending in acc
  uint64_t acc;  // pending bits, left-aligned (the first n bits of word `word`)
  __device__ Writer(uint32_t* words, int pos) : w(words), word(pos >> 5), n(pos & 31), acc(0) {}
  __device__ void put(uint32_t v, int len) {  // the low len (1..32) bits of v
    acc |= (uint64_t)v << (64 - n - len);
    n += len;
    if (n >= 32) {
      atomicOr(w + word, (uint32_t)(acc >> 32));
      ++word;
      acc <<= 32;
      n -= 32;
    }
  }
  __device__ void ue(uint32_t v) {
    uint32_t code = v + 1;
    int len = 32 - __clz(code);
    put(code, 2 * len - 1);
  }
  __device__ int pos() const { return 32 * word + n; }
  __device__ void finish() {
    if (n > 0) atomicOr(w + word, (uint32_t)(acc >> 32));
  }
};

// OR `v` (32 bits) into the row's words at bit `pos`.
__device__ __forceinline__ void or_bits(uint32_t* row, int pos, uint32_t v) {
  int q = pos >> 5, off = pos & 31;
  atomicOr(row + q, v >> off);
  if (off) atomicOr(row + q + 1, v << (32 - off));
}

// The bits of CAVLC residual_block() for levels c[0..max_coeff) in scan
// order (registers: every index is a constant after unrolling); nc -1 is
// the 4:2:0 chroma DC. `bad`: a level past Baseline's level_prefix <= 15
// (the macroblock then takes the escape). No branch: the lanes of the warp
// take different paths through the same positions, so each position's
// terms are computed and selected; the run_before lookups do not wait on
// one another.
__device__ __forceinline__ int cavlc_len(const int (&c)[16], int max_coeff, int nc, const Tables& T, bool& bad) {
  unsigned nzm = 0, ones = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    nzm |= (unsigned)(c[i] != 0) << i;
    ones |= (unsigned)(c[i] == 1 || c[i] == -1) << i;
  }
  const int tc = __popc(nzm);
  int t1 = 0;  // the trailing ones: the highest coefficients while they are +-1, at most three
  unsigned m = nzm;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int p = (31 - __clz(m)) & 31;
    const bool one = m != 0 && t1 == r && ((ones >> p) & 1);
    t1 += one;
    m ^= one ? 1u << p : 0u;
  }
  const int table = nc < 0 ? -1 : (nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3)));
  const uint8_t* tokens = table < 0 ? T.dc_len : T.tok_len[table < 0 ? 0 : table];
  int len = tokens[tc * 4 + t1] + t1;  // coeff_token, the trailing ones' signs
  const int total_zeros = 32 - __clz(nzm) - tc;
  const bool tz = tc > 0 && tc < max_coeff;
  len += tz ? (table < 0 ? T.dctz_len[tc - 1][total_zeros] : T.tz_len[tc - 1][total_zeros]) : 0;
  const uint8_t* runs = &T.run_len[0][0];
  int seen = 0, prev = 0, suffix = (tc > 10 && t1 < 3) ? 1 : 0;
#pragma unroll
  for (int i = 15; i >= 0; --i) {
    const bool nz = (nzm >> i) & 1;
    // level_prefix and level_suffix of a coefficient past the trailing ones
    const int level = c[i];
    const int code = (level > 0 ? 2 * level - 2 : -2 * level - 1) - (seen == t1 && t1 < 3 ? 2 : 0);
    const int len0 = code < 14 ? code + 1 : (code < 30 ? 19 : 28);
    const int lens = code < (15 << suffix) ? (code >> suffix) + 1 + suffix : 28;
    const bool bad_code = suffix == 0 ? code >= 30 + 4096 : code - (15 << suffix) >= 4096;
    const bool is_level = nz && seen >= t1;
    len += is_level ? (suffix == 0 ? len0 : lens) : 0;
    bad |= is_level && bad_code;
    const int s1 = suffix == 0 ? 1 : suffix;
    suffix = is_level ? ((abs(level) > (3 << (s1 - 1)) && s1 < 6) ? s1 + 1 : s1) : suffix;
    // run_before of the previous coefficient, while zeros are left below it
    const int zeros_left = prev - (tc - seen);
    const bool is_run = nz && seen > 0 && zeros_left > 0;
    len += is_run ? runs[((zeros_left < 7 ? zeros_left : 7) - 1) * 16 + prev - i - 1] : 0;
    prev = nz ? i : prev;
    seen += nz;
  }
  return len;
}

// CAVLC residual_block() of the chain's lane `src` of a macroblock whose
// levels lie in L ([16][NBLK], slot 0 of each block the DC levels), read
// from shared memory in scan order.
__device__ void write_residual(Writer& wr, const Tables& T, const int16_t* L, int src, int nc) {
  const bool ac = src < 24, luma_dc = src == 24;
  const int max_coeff = ac ? 15 : (luma_dc ? 16 : 4);
  auto level = [&](int i) -> int {
    return ac ? L[T.zigzag[i + 1] * NBLK + src] : (luma_dc ? L[T.zigzag[i]] : L[16 + (src - 25) * 4 + i]);
  };
  unsigned nzm = 0, ones = 0;
  for (int i = 0; i < max_coeff; ++i) {
    const int v = level(i);
    nzm |= (unsigned)(v != 0) << i;
    ones |= (unsigned)(v == 1 || v == -1) << i;
  }
  const int tc = __popc(nzm);
  int t1 = 0;
  unsigned m = nzm;
  while (t1 < 3 && m) {
    const int p = 31 - __clz(m);
    if (!((ones >> p) & 1)) break;
    ++t1;
    m ^= 1u << p;
  }
  const int table = nc < 0 ? -1 : (nc < 2 ? 0 : (nc < 4 ? 1 : (nc < 8 ? 2 : 3)));
  const int idx = tc * 4 + t1;
  if (table < 0)
    wr.put(T.dc_bits[idx], T.dc_len[idx]);
  else
    wr.put(T.tok_bits[table][idx], T.tok_len[table][idx]);
  if (tc == 0) return;
  m = nzm;
  for (int k = 0; k < t1; ++k) {
    const int p = 31 - __clz(m);
    wr.put(level(p) < 0 ? 1 : 0, 1);
    m ^= 1u << p;
  }
  int suffix = (tc > 10 && t1 < 3) ? 1 : 0;
  for (int k = t1; k < tc; ++k) {
    const int p = 31 - __clz(m);
    m ^= 1u << p;
    const int lv = level(p);
    int code = lv > 0 ? 2 * lv - 2 : -2 * lv - 1;
    if (k == t1 && t1 < 3) code -= 2;
    if (suffix == 0) {
      if (code < 14)
        wr.put(1, code + 1);
      else if (code < 30)
        wr.put((1u << 4) | (code - 14), 19);
      else
        wr.put((1u << 12) | (code - 30), 28);
    } else if (code < (15 << suffix)) {
      wr.put((1u << suffix) | (code & ((1 << suffix) - 1)), (code >> suffix) + 1 + suffix);
    } else {
      wr.put((1u << 12) | (code - (15 << suffix)), 28);
    }
    if (suffix == 0) suffix = 1;
    if (abs(lv) > (3 << (suffix - 1)) && suffix < 6) ++suffix;
  }
  const int total_zeros = 32 - __clz(nzm) - tc;
  if (tc < max_coeff) {
    if (table < 0)
      wr.put(T.dctz_bits[tc - 1][total_zeros], T.dctz_len[tc - 1][total_zeros]);
    else
      wr.put(T.tz_bits[tc - 1][total_zeros], T.tz_len[tc - 1][total_zeros]);
  }
  int zeros_left = total_zeros;
  m = nzm;
  int p = 31 - __clz(m);
  m ^= 1u << p;
  for (int k = 0; k < tc - 1 && zeros_left > 0; ++k) {
    const int q = 31 - __clz(m);
    m ^= 1u << q;
    const int run = p - q - 1, t = (zeros_left < 7 ? zeros_left : 7) - 1;
    wr.put(T.run_bits[t][run], T.run_len[t][run]);
    zeros_left -= run;
    p = q;
  }
}

struct Row {
  const uint8_t* Y;  // [16][ys]
  const uint8_t* C;  // [2][8][cs]
  Slot* ring;        // macroblock mx in slot mx % RING
  uint64_t* full;    // [RING]: the slot's macroblock handed over
  uint64_t* empty;   // [RING]: and written
  uint32_t* words;   // the slice's RBSP
  int ys, cs, mbw;
};

// The chain: warp 0, a macroblock after another (see the file's comment).
// `left`: shared [32], the left macroblock's reconstructed right column
// (0..15 luma, 16..23 Cb, 24..31 Cr). Returns the slice's bits so far.
__device__ int produce(const Row& r, const Tables& T, int* left, int qp, int qpc, int pos) {
  const int lane = threadIdx.x & 31;
  const bool luma = lane < 16, chroma = lane >= 16 && lane < 24, blk = lane < 24;
  const int bx = luma ? (lane & 3) : ((lane - 16) & 1);
  const int by = luma ? (lane >> 2) : (((lane - 16) >> 1) & 1);
  const int cc = chroma ? (lane - 16) >> 2 : 0;
  const int q = luma ? qp : qpc, q6 = q / 6, qb = 15 + q6;
  const int mf0 = MF[q % 6][0], mf1 = MF[q % 6][1], mf2 = MF[q % 6][2];
  const int ls0 = 16 * V[q % 6][0], ls1 = 16 * V[q % 6][1], ls2 = 16 * V[q % 6][2];
  const int off_ac = (1 << qb) / 3, off_dc = (1 << (qb + 1)) / 3;
  int* const lp = left + (luma ? 4 * by : 16 + 8 * cc + 4 * by);  // this block's four rows of the left column
  // the SAD's pixels: luma row lane & 15, 8 pixels from 8 * (lane >> 4);
  // chroma component lane >> 4, row (lane >> 1) & 7, 4 pixels from 4 * (lane & 1)
  const int srow = lane & 15, shalf = lane >> 4, sc = lane >> 4, scy = (lane >> 1) & 7, schalf = lane & 1;
  // this lane's 4x4 source block: luma rows 4 * by, chroma component cc rows 4 * by
  const uint8_t* const bp = luma ? r.Y + 4 * by * r.ys + 4 * bx : r.C + (8 * cc + 4 * by) * r.cs + 4 * bx;
  const int bstride = luma ? r.ys : r.cs, bstep = luma ? 16 : 8;
  int left_nnz = -1;  // lanes of a row's first block: the left macroblock's AC count of that row's last block
  for (int mx = 0; mx < r.mbw; ++mx) {
    // stage transform: the source block's forward transform, before the mode is known (it is linear)
    int w[16];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t v = blk ? *reinterpret_cast<const uint32_t*>(bp + i * bstride + bstep * mx) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) w[i * 4 + j] = (v >> (8 * j)) & 255;
    }
    forward4x4(w);

    // stage modes: SAD of DC against Horizontal from the left column
    int dcy = 128, dcc = 128;
    bool mode_h = false, cmode_h = false;
    if (mx > 0) {
      const int lv = left[lane];
      dcy = (__reduce_add_sync(FULL, lane < 16 ? lv : 0) + 8) >> 4;
      int s4 = lv + __shfl_xor_sync(FULL, lv, 1);
      s4 += __shfl_xor_sync(FULL, s4, 2);
      const int dq = (s4 + 2) >> 2;  // lanes 16 + 4 * (c * 2 + h): chroma DC prediction of rows 4h..4h+3
      const int dcc_sad = __shfl_sync(FULL, dq, 16 + 4 * (sc * 2 + (scy >> 2)));
      dcc = __shfl_sync(FULL, dq, 16 + 4 * (cc * 2 + by));
      const uint32_t* yp = reinterpret_cast<const uint32_t*>(r.Y + srow * r.ys + 16 * mx + 8 * shalf);
      const uint32_t a0 = yp[0], a1 = yp[1];
      const uint32_t cp = *reinterpret_cast<const uint32_t*>(r.C + (sc * 8 + scy) * r.cs + 8 * mx + 4 * schalf);
      const uint32_t ld = 0x01010101u * dcy, lh = 0x01010101u * left[srow];
      const uint32_t cd = 0x01010101u * dcc_sad, ch = 0x01010101u * left[16 + 8 * sc + scy];
      // SADs of at most 65,280 (luma) and 32,640 (chroma): DC in the low half, Horizontal in the high one
      const unsigned sy =
          __reduce_add_sync(FULL, (__vsadu4(a0, ld) + __vsadu4(a1, ld)) | ((__vsadu4(a0, lh) + __vsadu4(a1, lh)) << 16));
      const unsigned sch = __reduce_add_sync(FULL, __vsadu4(cp, cd) | (__vsadu4(cp, ch) << 16));
      mode_h = (sy >> 16) < (sy & 0xffffu);
      cmode_h = (sch >> 16) < (sch & 0xffffu);
    }
    const bool hmode = luma ? mode_h : cmode_h;
    const int dc_pred = mx == 0 ? 128 : (luma ? dcy : dcc);

    // stage residual: the source's coefficients less the prediction's, the AC quantised
    if (mx > 0 && hmode) {  // Horizontal: rows of constant left values, the first column only
      int a = lp[0], b = lp[1], c = lp[2], d = lp[3];
      fwd1(a, b, c, d);
      w[0] -= 4 * a;
      w[4] -= 4 * b;
      w[8] -= 4 * c;
      w[12] -= 4 * d;
    } else {
      w[0] -= blk ? 16 * dc_pred : 0;
    }
    int lev[16], nnz = 0;
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      const int cls = pos_class(k);
      lev[k] = quant(w[k], cls == 0 ? mf0 : (cls == 1 ? mf1 : mf2), qb, off_ac);
      nnz += lev[k] != 0;
    }

    // stage hadamard: the DC levels (luma lane = raster index, chroma 16 + c * 4 + k)
    const int hd = dc_transform(w[0], luma);
    lev[0] = quant(luma ? hd >> 1 : hd, mf0, qb + 1, off_dc);
    Slot& slot = r.ring[mx % RING];
    if (CONSUMERS > 0 && mx >= RING) mbar_wait(&r.empty[mx % RING], (mx / RING - 1) & 1);  // its last macroblock written
    if (blk) {  // the levels, for the consumer
#pragma unroll
      for (int k = 0; k < 16; ++k) slot.lev[k][lane] = (int16_t)lev[k];
    }

    // stage cavlc: the coded block pattern, nC, and each segment's length
    const bool any_luma = __any_sync(FULL, luma && nnz > 0);
    const bool any_cac = __any_sync(FULL, chroma && nnz > 0);
    const bool any_cdc = __any_sync(FULL, chroma && lev[0] != 0);
    const int cbp_c = any_cac ? 2 : (any_cdc ? 1 : 0);
    const int na = __shfl_sync(FULL, nnz, blk && bx > 0 ? lane - 1 : lane);
    const int nb = __shfl_sync(FULL, nnz, blk && by > 0 ? lane - (luma ? 4 : 2) : lane);
    const int left0 = __shfl_sync(FULL, left_nnz, 0);
    const int nc = blk ? nc_of(bx > 0 ? na : left_nnz, by > 0 ? nb : -1) : (lane == 24 ? nc_of(left0, -1) : -1);
    int c[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {  // the segment's levels in scan order: the DC lanes gather theirs
      const int from = lane == 24 ? zigzag(i) : (lane == 25 ? 16 + (i & 3) : (lane == 26 ? 20 + (i & 3) : lane));
      const int g = __shfl_sync(FULL, lev[0], from);
      c[i] = blk ? (i < 15 ? lev[zigzag(i + 1)] : 0) : ((lane == 24 || (lane < 27 && i < 4)) ? g : 0);
    }
    const bool coded = luma ? any_luma
                            : (chroma ? cbp_c == 2 : (lane == 24 || lane == 27 || (lane < 27 && cbp_c != 0)));
    bool bad = false;
    int len = 0;
    if (lane == 27)
      len = ue_len(1 + (mode_h ? 1 : 2) + 4 * cbp_c + (any_luma ? 12 : 0)) + ue_len(cmode_h ? 1 : 0) + 1;
    else if (coded)
      len = cavlc_len(c, blk ? 15 : (lane == 24 ? 16 : 4), nc, T, bad);
    const int total = __reduce_add_sync(FULL, len);
    const bool esc = __any_sync(FULL, bad) || total > PCM_BITS;

    // stage recon: the right-hand column (luma bx 3, chroma bx 1) that the next macroblock predicts from
    const int hdc = dc_transform(lev[0], luma);
    const int rdc = luma ? (q6 >= 6 ? (hdc * ls0) << (q6 - 6) : (hdc * ls0 + (1 << (5 - q6))) >> (6 - q6))
                         : ((hdc * ls0) << q6) >> 5;
    const bool recon = blk && bx == (luma ? 3 : 1);
    int col[4];
    if (recon) {
      int d[16];
      d[0] = rdc;
#pragma unroll
      for (int k = 1; k < 16; ++k) {
        const int cls = pos_class(k), ls = cls == 0 ? ls0 : (cls == 1 ? ls1 : ls2);
        d[k] = q6 >= 4 ? (lev[k] * ls) << (q6 - 4) : (lev[k] * ls + (1 << (3 - q6))) >> (4 - q6);
      }
      int rr[4];  // the rows' inverse, element 3 only
#pragma unroll
      for (int i = 0; i < 4; ++i) rr[i] = (d[i * 4] + d[i * 4 + 2]) - (d[i * 4 + 1] + (d[i * 4 + 3] >> 1));
      const int e0 = rr[0] + rr[2], e1 = rr[0] - rr[2], e2 = (rr[1] >> 1) - rr[3], e3 = rr[1] + (rr[3] >> 1);
      const int res[4] = {e0 + e3, e1 + e2, e1 - e2, e0 - e3};
#pragma unroll
      for (int i = 0; i < 4; ++i) col[i] = clip255((mx > 0 && hmode ? lp[i] : dc_pred) + ((res[i] + 32) >> 6));
      if (esc) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          col[i] = luma ? r.Y[(4 * by + i) * r.ys + 16 * mx + 15] : r.C[(8 * cc + 4 * by + i) * r.cs + 8 * mx + 7];
      }
    }

    // stage publish: the record, then the next macroblock's left column and counts
    Meta& m = slot.meta;
    m.len[lane] = (uint16_t)len;
    m.nc[lane] = (int8_t)nc;
    if (lane == 0) {
      m.start = pos;
      m.flags = (mode_h ? MODE_H : 0) | (cmode_h ? CMODE_H : 0) | (any_luma ? CBP_LUMA : 0) | (cbp_c << 3) |
                (esc ? ESCAPE : 0);
    }
    const int right = __shfl_sync(FULL, nnz, blk && bx == 0 ? lane + (luma ? 3 : 1) : lane);
    if (blk && bx == 0) left_nnz = esc ? 16 : right;
    pos = esc ? ((pos + 9 + 7) & ~7) + PCM_BITS : pos + total;
    __syncwarp();  // every lane has read the left column and written its part of the record
    if (recon) {
#pragma unroll
      for (int i = 0; i < 4; ++i) lp[i] = col[i];
    }
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      mbar_arrive(&r.full[mx % RING]);
    }
  }
  return pos;
}

// A consumer warp: writes macroblocks first, first + CONSUMERS, ...
__device__ void consume(const Row& r, const Tables& T, int first) {
  const int lane = threadIdx.x & 31;
  for (int mx = first; mx < r.mbw; mx += CONSUMERS) {
    const Slot& slot = r.ring[mx % RING];
    mbar_wait(&r.full[mx % RING], (mx / RING) & 1);
    const Meta& m = slot.meta;
    const int flags = m.flags, start = m.start;
    if (flags & ESCAPE) {  // mb_type 25 (ue: 0000 11010), the alignment, 384 samples
      if (lane == 0) or_bits(r.words, start, 26u << 23);
      const int at = (start + 9 + 7) & ~7;
      for (int t = lane; t < 96; t += 32) {
        uint32_t v;
        if (t < 64) {
          v = *reinterpret_cast<const uint32_t*>(r.Y + (t >> 2) * r.ys + 16 * mx + 4 * (t & 3));
        } else {
          const int u = t - 64;
          v = *reinterpret_cast<const uint32_t*>(r.C + ((u >> 4) * 8 + ((u >> 1) & 7)) * r.cs + 8 * mx + 4 * (u & 1));
        }
        or_bits(r.words, at + 32 * t, __byte_perm(v, 0, 0x0123));
      }
    } else {
      const int src = lane < SEGS ? T.seg_lane[lane] : 0;
      const int len = lane < SEGS ? m.len[src] : 0;
      int end = len;  // the segments' offsets: an inclusive scan in bitstream order
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, end, o);
        if (lane >= o) end += v;
      }
      if (len > 0) {
        Writer wr(r.words, start + end - len);
        if (lane == 0) {
          wr.ue(1 + ((flags & MODE_H) ? 1 : 2) + 4 * ((flags >> 3) & 3) + ((flags & CBP_LUMA) ? 12 : 0));
          wr.ue((flags & CMODE_H) ? 1 : 0);
          wr.put(1, 1);  // mb_qp_delta 0
        } else {
          write_residual(wr, T, &slot.lev[0][0], src, m.nc[src]);
        }
        wr.finish();
      }
    }
    __syncwarp();  // every lane is done with the slot
    if (lane == 0) mbar_arrive(&r.empty[mx % RING]);
  }
}

// Block-wide exclusive scans (every thread calls them): the max (identity
// -1) and the sum of `v`; `total` gets the whole block's.
__device__ int block_exclusive_max(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl = max(incl, u);
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = -1, all = -1;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before = max(before, scratch[w]);
    all = max(all, scratch[w]);
  }
  int ex = __shfl_up_sync(FULL, incl, 1);
  __syncthreads();  // scratch is free again
  total = all;
  return lane == 0 ? before : max(before, ex);
}
__device__ int block_exclusive_sum(int v, int* scratch, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w < warp) before += scratch[w];
    all += scratch[w];
  }
  __syncthreads();
  total = all;
  return before + incl - v;
}

__device__ __forceinline__ void copy_table(uint8_t* dst, const uint8_t* src, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
}

// SHARED_WORDS: the row's words and the staged unit in shared memory;
// else the words at byte `words_at` of the block's row of `units` and the
// unit written straight to the row's start.
template <bool SHARED_WORDS>
__global__ void __launch_bounds__(THREADS, 2)
    h264_intra_kernel(const uint8_t* __restrict__ rgb, int H, int W, int mbh, int mbw, int first_index, int qp,
                      int row_words, uint8_t* __restrict__ units, int unit_stride, int words_at,
                      int* __restrict__ unit_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Tables T;
  __shared__ int left[32], scratch[WARPS], s_pos;
  const Layout lay = layout(mbw, row_words, SHARED_WORDS);
  const int slice = blockIdx.x, frame = slice / mbh, row = slice % mbh;
  uint8_t* const unit = units + (size_t)slice * unit_stride;
  Row r;
  r.full = reinterpret_cast<uint64_t*>(smem + lay.full);
  r.empty = reinterpret_cast<uint64_t*>(smem + lay.empty);
  r.ring = reinterpret_cast<Slot*>(smem + lay.ring);
  r.words = reinterpret_cast<uint32_t*>(SHARED_WORDS ? smem + lay.words : unit + words_at);
  uint8_t* Ys = smem + lay.y;
  uint8_t* Cs = smem + lay.c;
  r.Y = Ys;
  r.C = Cs;
  r.ys = lay.ys;
  r.cs = lay.cs;
  r.mbw = mbw;
  const int t = threadIdx.x, warp = t >> 5;
  const int qpc = qp < 30 ? qp : QPC[qp - 30];

  // stage prepass: tables, zeroed words, mbarriers, the pixels to Y'CbCr 4:2:0
  copy_table(&T.tok_len[0][0], &TOKEN_LEN[0][0], sizeof(T.tok_len));
  copy_table(&T.tok_bits[0][0], &TOKEN_BITS[0][0], sizeof(T.tok_bits));
  copy_table(T.dc_len, DC_TOKEN_LEN, sizeof(T.dc_len));
  copy_table(T.dc_bits, DC_TOKEN_BITS, sizeof(T.dc_bits));
  copy_table(&T.tz_len[0][0], &TZ_LEN[0][0], sizeof(T.tz_len));
  copy_table(&T.tz_bits[0][0], &TZ_BITS[0][0], sizeof(T.tz_bits));
  copy_table(&T.dctz_len[0][0], &DC_TZ_LEN[0][0], sizeof(T.dctz_len));
  copy_table(&T.dctz_bits[0][0], &DC_TZ_BITS[0][0], sizeof(T.dctz_bits));
  copy_table(&T.run_len[0][0], &RUN_LEN[0][0], sizeof(T.run_len));
  copy_table(&T.run_bits[0][0], &RUN_BITS[0][0], sizeof(T.run_bits));
  copy_table(T.zigzag, ZIGZAG, sizeof(T.zigzag));
  if (t < SEGS)  // header, luma DC, luma AC in luma4x4BlkIdx order, chroma DC, chroma AC
    T.seg_lane[t] = t == 0 ? 27 : (t == 1 ? 24 : (t < 18 ? BLK_Y[t - 2] * 4 + BLK_X[t - 2] : (t < 20 ? t + 7 : t - 4)));
  for (int i = t; i < row_words; i += THREADS) r.words[i] = 0u;
  if (t < 2 * RING) mbar_init(&r.full[t]);  // full and empty: one array
  const uint8_t* src = rgb + (size_t)frame * H * W * 3;
  const int Wc = 8 * mbw;
  for (int qd = t; qd < 8 * Wc; qd += THREADS) {
    const int qy = qd / Wc, qx = qd % Wc;
    int rs = 0, gs = 0, bs = 0;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const int y = min(row * 16 + 2 * qy + dy, H - 1), x = min(2 * qx + dx, W - 1);
        const uint8_t* p = src + ((size_t)y * W + x) * 3;
        const int cr = p[0], cg = p[1], cb = p[2];
        Ys[(2 * qy + dy) * lay.ys + 2 * qx + dx] = (uint8_t)(((66 * cr + 129 * cg + 25 * cb + 128) >> 8) + 16);
        rs += cr;
        gs += cg;
        bs += cb;
      }
    Cs[qy * lay.cs + qx] = (uint8_t)(((-38 * rs - 74 * gs + 112 * bs + 512) >> 10) + 128);
    Cs[(8 + qy) * lay.cs + qx] = (uint8_t)(((112 * rs - 94 * gs - 18 * bs + 512) >> 10) + 128);
  }
  __syncthreads();
  if (warp == 0) {
    int pos = 0;
    if (t == 0) {
      // slice_header(): first_mb_in_slice, slice_type 7, pps 0, frame_num 0,
      // idr_pic_id, dec_ref_pic_marking, slice_qp_delta, deblocking off (1)
      Writer wr(r.words, 0);
      wr.ue(row * mbw);
      wr.ue(7);
      wr.ue(0);
      wr.put(0, 4);
      wr.ue((first_index + frame) & 1);
      wr.put(0, 2);
      const int d = qp - 26;
      wr.ue(d > 0 ? 2 * d - 1 : -2 * d);
      wr.ue(1);
      wr.finish();
      pos = wr.pos();
    }
    pos = produce(r, T, left, qp, qpc, __shfl_sync(FULL, pos, 0));
    if (t == 0) s_pos = pos;
  } else if (warp <= CONSUMERS) {
    consume(r, T, warp - 1);
  }
  __syncthreads();

  // stage framing: the stop bit, then the NAL unit
  if (t == 0) or_bits(r.words, s_pos, 1u << 31);  // rbsp_slice_trailing_bits
  __syncthreads();
  const int nbytes = (s_pos + 1 + 7) >> 3;
  {
    const uint32_t* words = r.words;
    auto byte_at = [words](int j) -> int { return (words[j >> 2] >> (24 - 8 * (j & 3))) & 0xff; };
    const int span = (nbytes + THREADS - 1) / THREADS;
    const int lo = min(t * span, nbytes), hi = min(lo + span, nbytes);
    int last = -1;
    for (int j = lo; j < hi; ++j)
      if (byte_at(j)) last = j;
    int unused, inserted;
    const int prev = block_exclusive_max(last, scratch, unused);  // -1: the NAL header byte, not zero
    int ins = 0;
    for (int j = lo, p = prev; j < hi; ++j) {
      const int b = byte_at(j), zeros = j - p - 1;
      ins += b <= 3 && zeros >= 2 && (zeros & 1) == 0;
      if (b) p = j;
    }
    const int before = block_exclusive_sum(ins, scratch, inserted);
    uint8_t* out = SHARED_WORDS ? smem + lay.ring : unit;  // the ring and the pixels are dead: staged there
    for (int j = lo, p = prev, o = 5 + lo + before; j < hi; ++j) {
      const int b = byte_at(j), zeros = j - p - 1;
      if (b <= 3 && zeros >= 2 && (zeros & 1) == 0) out[o++] = 3;
      out[o++] = (uint8_t)b;
      if (b) p = j;
    }
    const int n = 1 + nbytes + inserted;  // the NAL unit's bytes: its header byte and the slice
    if (t == 0) {
      out[0] = (uint8_t)(n >> 24);
      out[1] = (uint8_t)(n >> 16);
      out[2] = (uint8_t)(n >> 8);
      out[3] = (uint8_t)n;
      out[4] = 0x65;  // nal_ref_idc 3, nal_unit_type 5 (IDR)
    }
    if (SHARED_WORDS) {
      __syncthreads();
      const uint4* s16 = reinterpret_cast<const uint4*>(out);
      uint4* d16 = reinterpret_cast<uint4*>(unit);
      for (int i = t; i < (4 + n + 15) / 16; i += THREADS) d16[i] = s16[i];
    }
    if (t == 0) unit_bytes[slice] = 4 + n;
  }
}

// The dynamic shared memory a block of the SHARED_WORDS instantiation
// may take on the current device, in `limit` (the card's opt-in maximum
// less the kernel's static shared memory); returns a CUDA error.
template <bool SHARED_WORDS>
int smem_limit(int& limit) {
  static int limits[64];  // per device (the same value whichever thread sets it)
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (limits[dev] == 0) {
    int optin = 0;
    cudaFuncAttributes attr;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, h264_intra_kernel<SHARED_WORDS>);
    if (err != cudaSuccess) return (int)err;
    limits[dev] = optin - (int)attr.sharedSizeBytes;
  }
  limit = limits[dev];
  return 0;
}

template <bool SHARED_WORDS>
int launch(const uint8_t* rgb, int B, int H, int W, int first_index, int qp, int row_words, uint8_t* units,
           int unit_stride, int words_at, int* unit_bytes, cudaStream_t stream) {
  static int allowed[64];  // per device: the most this kernel was allowed so far
  const int mbh = (H + 15) / 16, mbw = (W + 15) / 16;
  const int smem = layout(mbw, row_words, SHARED_WORDS).bytes;
  int limit = 0, dev = 0;
  int rc = smem_limit<SHARED_WORDS>(limit);
  if (rc != 0) return rc;
  if (smem > limit) return -2;
  cudaGetDevice(&dev);
  if (smem > allowed[dev]) {
    cudaError_t err =
        cudaFuncSetAttribute(h264_intra_kernel<SHARED_WORDS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = smem;
  }
  h264_intra_kernel<SHARED_WORDS><<<B * mbh, THREADS, smem, stream>>>(rgb, H, W, mbh, mbw, first_index, qp, row_words,
                                                                      units, unit_stride, words_at, unit_bytes);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Where a block of frames W wide keeps its slice's words on the current
// device: `*shared` 1 in shared memory, 0 in its row of `units` (which is
// then the unit's bound and 4 * row_words bytes more). Returns a CUDA
// error, or -2 where the pixels and the ring alone take more shared memory
// than the card gives a block.
int gfpp_h264_plan(int W, int row_words, int* shared) {
  const int mbw = (W + 15) / 16;
  int limit = 0;
  int rc = smem_limit<true>(limit);
  if (rc != 0) return rc;
  *shared = layout(mbw, row_words, true).bytes <= limit;
  if (*shared) return 0;
  rc = smem_limit<false>(limit);
  if (rc != 0) return rc;
  return layout(mbw, row_words, false).bytes <= limit ? 0 : -2;
}

// frames [B, H, W, 3] uint8 RGB (contiguous) -> each slice's NAL unit as
// the file holds it (4-byte AVCC length, header byte, emulation
// prevention) at the start of its row of `units` ([B * mb_rows,
// unit_stride], a multiple of 16 bytes; the bytes past the unit are not
// specified) and its bytes [B * mb_rows]; `row_words` bounds a slice's RBSP
// (data/h264.py:row_bytes / 4). `words_at` -1: the words in shared memory;
// else their byte offset in each row of `units`, past the unit's bound
// (gfpp_h264_plan says which). Returns a CUDA error, or -2 where the
// layout takes more shared memory than the card gives a block.
int gfpp_h264_intra(const uint8_t* rgb, int B, int H, int W, int first_index, int qp, int row_words,
                    uint8_t* units, int unit_stride, int words_at, int* unit_bytes, cudaStream_t stream) {
  return words_at < 0 ? launch<true>(rgb, B, H, W, first_index, qp, row_words, units, unit_stride, -1, unit_bytes,
                                     stream)
                      : launch<false>(rgb, B, H, W, first_index, qp, row_words, units, unit_stride, words_at,
                                      unit_bytes, stream);
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
  for (int i = 0; i < 16; ++i)
    if (zz[i] != zigzag(i)) return -1;  // the chain's constant-expression scan order
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
