// Device functions of the fused head-field kernels: the fast sin/cos/tanh
// of ops/fastmath.py and the SH16 basis of the Pallas kernel (all
// kernels), the table of the weight-gradient operands that the forward's
// train mode and the backward's chain hand to fused_field_wgrad.cu, the
// stores that write those operands from register fragments (the train
// mode and the chain), and the layout of the ReLU masks the train mode
// hands to the chain.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace gfpp {

typedef __nv_bfloat16 bf16;

// ops/fastmath.py, term for term
__device__ __forceinline__ float fast_sin(float x) {
  const float u = x * 0.15915494309189535f;  // 1 / (2 pi)
  const float t = u - rintf(u);              // round half to even, as jnp.round
  const float t2 = t * t;
  return t * (6.2830885f + t2 * (-41.3332475f + t2 * (81.4000898f +
              t2 * (-74.6758839f + t2 * 33.1680946f))));
}

__device__ __forceinline__ float fast_cos(float x) {
  return fast_sin(x + 1.5707963267948966f);
}

__device__ __forceinline__ float fast_tanh(float x) {
  x = fminf(fmaxf(x, -7.9f), 7.9f);
  const float x2 = x * x;
  const float num = x * (135135.0f + x2 * (17325.0f + x2 * (378.0f + x2)));
  const float den = 135135.0f + x2 * (62370.0f + x2 * (3150.0f + x2 * 28.0f));
  return fminf(fmaxf(num / den, -1.0f), 1.0f);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// degree-4 real SH basis, rounded to bf16 (fused_field.py:_sh16)
__device__ __forceinline__ void sh16(const float* d, bf16* out) {
  const float x = d[0], y = d[1], z = d[2];
  const float xy = x * y, xz = x * z, yz = y * z;
  const float x2 = x * x, y2 = y * y, z2 = z * z;
  const float v[16] = {
      0.28209479177387814f,
      -0.48860251190291987f * y,
      0.48860251190291987f * z,
      -0.48860251190291987f * x,
      1.0925484305920792f * xy,
      -1.0925484305920792f * yz,
      0.94617469575755997f * z2 - 0.31539156525251999f,
      -1.0925484305920792f * xz,
      0.54627421529603959f * (x2 - y2),
      0.59004358992664352f * y * (-3.0f * x2 + y2),
      2.8906114426405538f * xy * z,
      0.45704579946446572f * y * (1.0f - 5.0f * z2),
      0.3731763325901154f * z * (5.0f * z2 - 3.0f),
      0.45704579946446572f * x * (1.0f - 5.0f * z2),
      1.4453057213202769f * z * (x2 - y2),
      0.59004358992664352f * x * (-x2 + 3.0f * y2)};
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16_rn(v[i]);
}

// The backward's weight-gradient operands, which fused_field_wgrad.cu sums
// over all points. Two kernels write them: the forward's train mode
// (fused_field.cu, TRAIN_OPERANDS: the activations, 1,184 rows) and the
// backward's chain (fused_field_bwd.cu, CHAIN_OPERANDS: the gradients, 984
// rows); ops/fused_field.py's OPERAND_WRITERS is the same split, compared
// when each library loads. Each operand is [n points, rows] bf16, zero past
// n, in one buffer in this order (ops/fused_field.py, WGRAD_OPERANDS),
// operand o at npad * first row of o values, npad = n rounded up to the
// 64-point tile. Within an operand the points are K of a wgmma operand:
// K-major in sm90.cuh's layout, k16 step s (points 16 s .. 16 s + 15) a
// block of rows * 16 values, so a run of k steps is one contiguous bulk
// copy.
enum Operand {
  OP_X0, OP_X1, OP_X2, OP_X3,  // pos_feat, 64 features each
  OP_XA,                       // amb_feat
  OP_A1, OP_A2, OP_S1, OP_S2, OP_C1,  // bf16 hidden layers
  OP_GC1A, OP_GC1B,            // g_c1 features 0..63, 64..127
  OP_GAPROJ, OP_GPROJ,         // bf16(g_aproj), bf16(g_proj)
  OP_GS1, OP_GA1, OP_GA2, OP_GS2,
  OP_GSIG,                     // [g_geo 128 | g_sigma_logit | 0 x 7]
  OP_G,                        // [geo 128 | SH 16]
  OP_GRGB, OP_GAMB,            // g_rgb_logit, g_amb_logit: 3 live of 8
  OP_APOS, OP_XYZB,            // bf16(amb_pos), bf16(xyz): 3 live of 8
  N_OPERANDS
};
constexpr int OP_ROWS[N_OPERANDS] = {64, 64, 64, 64, 128, 128, 128, 128, 128, 128, 64, 64,
                                     64, 128, 128, 128, 128, 128, 136, 144, 8, 8, 8, 8};

__host__ __device__ constexpr int op_first_row(int o) {
  int r = 0;
  for (int i = 0; i < o; ++i) r += OP_ROWS[i];
  return r;
}

constexpr int OPERAND_ROWS = op_first_row(N_OPERANDS);  // 2,168 bf16 a point
static_assert(OPERAND_ROWS == 2168, "operand table");

// which kernel writes which operand (each exactly once)
constexpr int TRAIN_OPERANDS[] = {OP_X0, OP_X1, OP_X2, OP_X3, OP_XA, OP_A1, OP_A2,
                                  OP_S1, OP_S2, OP_C1, OP_G, OP_APOS, OP_XYZB};
constexpr int CHAIN_OPERANDS[] = {OP_GC1A, OP_GC1B, OP_GAPROJ, OP_GPROJ, OP_GS1, OP_GA1,
                                  OP_GA2, OP_GS2, OP_GSIG, OP_GRGB, OP_GAMB};
constexpr int N_TRAIN_OPERANDS = sizeof(TRAIN_OPERANDS) / sizeof(int);
constexpr int N_CHAIN_OPERANDS = sizeof(CHAIN_OPERANDS) / sizeof(int);

template <int N>
__host__ __device__ constexpr bool listed(int o, const int (&list)[N]) {
  for (int i = 0; i < N; ++i)
    if (list[i] == o) return true;
  return false;
}

template <int N>
__host__ __device__ constexpr int listed_rows(const int (&list)[N]) {
  int r = 0;
  for (int i = 0; i < N; ++i) r += OP_ROWS[list[i]];
  return r;
}

__host__ __device__ constexpr bool owned_once() {
  for (int o = 0; o < N_OPERANDS; ++o)
    if (listed(o, TRAIN_OPERANDS) == listed(o, CHAIN_OPERANDS)) return false;
  return true;
}
static_assert(owned_once() && N_TRAIN_OPERANDS + N_CHAIN_OPERANDS == N_OPERANDS, "operand writers");
static_assert(listed_rows(TRAIN_OPERANDS) == 1184 && listed_rows(CHAIN_OPERANDS) == 984, "operand writers");

// ---- operand stores from register fragments (sm90.cuh's layout) ----
// A warpgroup's 64-point tile is one k range of every operand, and a
// warp's 16 rows are one k16 step. A bf16 pair of an A fragment (or of an
// accumulator, rounded) of one 8-feature block is an m8n8 matrix, rows 8
// points, columns 2 features a lane; movmatrix.trans turns it into 2
// points of one feature a lane, and the warp's 32 4-byte stores fill one
// contiguous 128-byte core matrix of the operand (8 features x 8 points).
//
// Where this warp's lane writes core matrix 0 of operand O in the k16 step
// of its 16 rows: the operand's tile at `base`, step `warp`, then 4 bytes a
// lane (feature g, points 2 t, 2 t + 1 of the core matrix). Core matrix c
// (feature group j, point half h: c = 2 j + h) is 32 words further on.
template <int O>
__device__ __forceinline__ uint32_t* operand_dst(bf16* ops, int npad, int base, int warp, int lane) {
  constexpr int R = OP_ROWS[O];
  return reinterpret_cast<uint32_t*>(ops + static_cast<size_t>(npad) * op_first_row(O) +
                                     static_cast<size_t>(base) * R + warp * R * 16) + lane;
}

// the 8 x 8 fragment x (this lane: row g or g + 8, 2 features) as the core
// matrix at dst (operand_dst + 32 c), zero if the lane's row is past n
__device__ __forceinline__ void store_fragment(uint32_t* dst, uint32_t x, bool live_row) {
  *dst = sm90::movmatrix_trans(live_row ? x : 0u);
}

// k16 steps S0 .. S1 - 1 of a layer held as A fragments (h[s][i]: feature
// block 2 s + i / 2, rows g + 8 (i % 2)) as core matrices 4 (s - S0) + i
template <int S0, int S1, int S>
__device__ __forceinline__ void store_fragments(uint32_t* dst, const uint32_t (&h)[S][4], bool live_g,
                                                bool live_h) {
#pragma unroll
  for (int s = S0; s < S1; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) store_fragment(dst + 32 * (4 * (s - S0) + i), h[s][i], (i & 1) ? live_h : live_g);
}

// The ReLU masks of the five hidden layers (a1, a2, s1, s2, c1), written by
// the forward's train mode and read by the chain instead of the
// activations: uint32 words relu[(l * npad + p) * 4 + t] for layer l and
// point p, 80 bytes a point (zero past n). Bit 2 j + e of word t is
// (bf16 activation > 0) of feature 8 j + 2 t + e: the four words of a
// point are the four lanes of a wgmma accumulator's row quad.
constexpr int RELU_LAYERS = 5, RELU_WORDS = 4;
__host__ __device__ constexpr int relu_word(int f) { return (f >> 1) & 3; }
__host__ __device__ constexpr int relu_bit(int f) { return 2 * (f >> 3) + (f & 1); }

}  // namespace gfpp
