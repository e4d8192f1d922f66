// Device functions of the fused head-field kernels: the fast sin/cos/tanh
// of ops/fastmath.py and the SH16 basis of the Pallas kernel (both kernels),
// and the backward's tile products on the tensor cores (fused_field_bwd.cu;
// WMMA m16n16k16, bf16 inputs, f32 sums).
//
// Every product walks k in ascending 16-steps into one accumulator per
// output fragment, whichever warp owns the fragment, so a block of 4 warps
// and a block of 8 warps give bit-identical products.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

// C[0:TM, 0:N] = A[0:TM, 0:K] . W[0:K, 0:N]: A bf16 in shared memory (row
// stride LDA), W bf16 row-major in global memory (row stride LDW), C f32 in
// shared memory (row stride LDC). Warp w computes the 16-column strips w,
// w+NW, ... for all TM rows, so each W fragment is loaded once and used
// TM/16 times.
template <int TM, int NW, int K, int N, int LDA, int LDW, int LDC>
__device__ __forceinline__ void tile_matmul(const bf16* A, const bf16* __restrict__ W, float* C) {
  const int warp = threadIdx.x >> 5;
  for (int nt = warp; nt < N / 16; nt += NW) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[TM / 16];
#pragma unroll
    for (int m = 0; m < TM / 16; ++m) wmma::fill_fragment(acc[m], 0.0f);
#pragma unroll 2
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(b, W + k * LDW + nt * 16, LDW);
#pragma unroll
      for (int m = 0; m < TM / 16; ++m) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, A + m * 16 * LDA + k, LDA);
        wmma::mma_sync(acc[m], a, b, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < TM / 16; ++m)
      wmma::store_matrix_sync(C + m * 16 * LDC + nt * 16, acc[m], LDC, wmma::mem_row_major);
  }
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

// P[0:M, 0:N] (+)= A[0:TM, 0:M]^T . G[0:TM, 0:N]: the weight-gradient
// product of a layer over one tile of TM points (K = TM). A is the layer's
// bf16 input and G its bf16 output gradient, both row-major in shared
// memory, A read column-major as the A fragment. P is f32 row-major (row
// stride LDP) in device memory, owned by this block alone: `first` stores
// the tile's product, otherwise the accumulator starts from P. A fragment
// is always handled by the same warp, so a block sees its own writes.
template <int TM, int NW, int M, int N, int LDA, int LDG, int LDP>
__device__ __forceinline__ void tile_wgrad(const bf16* A, const bf16* G, float* P, bool first) {
  const int warp = threadIdx.x >> 5;
  constexpr int NT = N / 16;
  for (int f = warp; f < (M / 16) * NT; f += NW) {
    const int mt = f / NT, nt = f % NT;
    float* p = P + mt * 16 * LDP + nt * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (first)
      wmma::fill_fragment(acc, 0.0f);
    else
      wmma::load_matrix_sync(acc, p, LDP, wmma::mem_row_major);
#pragma unroll
    for (int k = 0; k < TM; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, A + k * LDA + mt * 16, LDA);
      wmma::load_matrix_sync(b, G + k * LDG + nt * 16, LDG);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(p, acc, LDP, wmma::mem_row_major);
  }
}

}  // namespace gfpp
