// Device functions of the fused head-field kernels: the fast sin/cos/tanh
// of ops/fastmath.py and the SH16 basis of the Pallas kernel (all
// kernels), the backward chain's input-gradient tile products on the
// tensor cores (fused_field_bwd.cu; WMMA m16n16k16, bf16 inputs, f32
// sums), the table of the weight-gradient operands that the forward's
// train mode and the chain hand to fused_field_wgrad.cu, and the layout of
// the ReLU masks the train mode hands to the chain.
//
// Every product walks k in ascending 16-steps into one accumulator per
// output fragment, whichever warp owns the fragment, so a block of 4 warps
// and a block of 8 warps give bit-identical products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace gfpp {

using namespace nvcuda;
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

// C[0:TM, 0:N] = A1[0:TM, 0:K] . W1^T (+ A2[0:TM, 0:K] . W2^T when A2 is
// given; row strides LDA and LDA2): the input-gradient product of a layer
// y = x . W. W is the layer's
// bf16 weight, row-major [N rows, LDW] in global memory, read as W[n][k] for
// k < K: the same weights as the forward, loaded column-major as the B
// fragment, so no transposed copy exists.
template <int TM, int NW, int K, int N, int LDA, int LDW, int LDC, int LDA2 = LDA>
__device__ __forceinline__ void tile_matmul_wt(const bf16* A1, const bf16* __restrict__ W1,
                                               const bf16* A2, const bf16* __restrict__ W2,
                                               float* C) {
  const int warp = threadIdx.x >> 5;
  for (int nt = warp; nt < N / 16; nt += NW) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TM / 16];
#pragma unroll
    for (int m = 0; m < TM / 16; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int pass = 0; pass < (A2 != nullptr ? 2 : 1); ++pass) {
      const bf16* A = pass == 0 ? A1 : A2;
      const bf16* W = pass == 0 ? W1 : W2;
      const int lda = pass == 0 ? LDA : LDA2;
#pragma unroll 2
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, W + nt * 16 * LDW + k, LDW);
#pragma unroll
        for (int m = 0; m < TM / 16; ++m) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::load_matrix_sync(a, A + m * 16 * lda + k, lda);
          wmma::mma_sync(acc[m], a, b, acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < TM / 16; ++m)
      wmma::store_matrix_sync(C + m * 16 * LDC + nt * 16, acc[m], LDC, wmma::mem_row_major);
  }
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
