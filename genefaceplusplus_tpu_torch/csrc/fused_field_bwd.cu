// Fused RAD-NeRF head-field backward for Hopper (sm_90a): the tile chain.
//
// Replaces, with fused_field_wgrad.cu, the TPU kernel
// genefaceplusplus_tpu/ops/pallas/fused_field.py:_bwd_kernel (launched by
// _fused_backward, pallas_call at :423, under fused_field_train). Per tile
// of points it recomputes the forward chain of fused_field.cu (same device
// functions, same bf16 rounding points), backpropagates the output
// gradients (sigma, rgb, ambient coordinate) through the colour, sigma and
// ambient MLPs and both Fourier projections, and writes the bf16 operands
// of every weight-gradient product (fused_field_common.cuh, Operand) to
// device memory. fused_field_wgrad.cu sums their products over all points.
//
// What bounds it on an H100: arithmetic, about twice the forward's (the
// forward recomputed and an input-gradient product per layer), against 52
// bytes of point traffic in and 4,336 bytes of operands out a point
// (1.36 ms for 4.5 GB at 1,048,576 points).
//
// Design:
// * Why two kernels. The Pallas kernel adds every tile's weight gradients
//   into one VMEM accumulator, which relies on the TPU grid running in
//   order on one core. The 14 gradient blocks (605 KB of f32) fit neither
//   in an SM's shared memory nor in its registers, so a one-kernel port
//   reads and rewrites a per-block f32 partial for every 64 points. Here
//   the chain only writes the bf16 operands, once, and the weight-gradient
//   kernel keeps its sums in registers over thousands of points.
// * Operand stores. Each operand's 64-point tile is a contiguous 64 x rows
//   block in the wgmma layout (K = points); a thread gathers 8 points of
//   one feature from the tile's shared-memory buffer and writes them as
//   one 16-byte store, consecutive threads to consecutive addresses. Rows
//   past n are written as zeros. Each store sits between the barriers
//   that keep its source buffer unchanged.
// * Products with transposed weights. The input gradient g . W^T reads the
//   same bf16 weights as the forward, loaded column-major as the B
//   fragment. No transposed copy exists.
// * Padding. Only live columns move, as in the forward: 3 of 128 ambient
//   (16-wide fragments), 1 + 128 of 256 sigma|geo (144), 3 of 128 rgb (16).
// * The ragged last tile. Rows past n read zero inputs and zero output
//   gradients, so every gradient they touch is exactly zero.
// * Rounding and derivatives as the Pallas kernel has them. g_rgb_logit,
//   g_c1, g_sig_out, g_s2, g_s1, g_amb_logit, g_a2 and g_a1 round to bf16 (the
//   tensor-core inputs); a ReLU mask tests the activation (relu(x) > 0, read
//   from its bf16 copy: equal unless x < 2^-133); sin/cos derivatives use the
//   forward's fast_cos/fast_sin values, tanh's is 1 - amb_pos^2; amb_B,
//   amb_pos, g_aproj, xyz and g_proj round to bf16 for their products; the
//   sigma gradient is gated to logits in (-15, 15).
// * Shared memory (218,624 bytes, one block per SM, 8 warps): the tile's
//   bf16 activations stay resident for the backward (pos|amb features, the
//   five hidden layers, SH|geo), with one f32 product tile and one bf16
//   gradient tile; buffers that die early are reused for later gradients.
//
// Build (no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_field_bwd.so fused_field_bwd.cu

#include "fused_field_common.cuh"

using gfpp::bf16;
using gfpp::bf16_round;
using gfpp::fast_cos;
using gfpp::fast_sin;
using gfpp::fast_tanh;

namespace {

constexpr int TM = 64;  // points per tile
constexpr int NW = 8;   // warps per block
constexpr int NT = 32 * NW;
constexpr int AMB = 3;

constexpr int LDX = 392;  // bf16 [pos_feat 256 | amb_feat 128]
constexpr int LDH = 136;  // bf16 hidden layer
constexpr int LDG = 152;  // bf16 [SH 16 | geo 128], and the gradient tile
constexpr int LDC = 148;  // f32 product tile
constexpr int LDP = 132;  // f32 position-Fourier gradient
constexpr int LDQ = 72;   // bf16 ambient-Fourier gradient
constexpr int LDS = 24;   // bf16 ambient-logit gradient

constexpr int OFF_A1 = 2 * TM * LDX;
constexpr int OFF_A2 = OFF_A1 + 2 * TM * LDH;
constexpr int OFF_S1 = OFF_A2 + 2 * TM * LDH;
constexpr int OFF_S2 = OFF_S1 + 2 * TM * LDH;
constexpr int OFF_C1 = OFF_S2 + 2 * TM * LDH;
constexpr int OFF_G = OFF_C1 + 2 * TM * LDH;
constexpr int OFF_GB = OFF_G + 2 * TM * LDG;
constexpr int OFF_C = OFF_GB + 2 * TM * LDG;
constexpr int OFF_PT = OFF_C + 4 * TM * LDC;
constexpr int PT_FLOATS = TM * (3 + 3 + 3 + 1 + 3 + 3 + 1 + 1);
constexpr int SMEM_BYTES = OFF_PT + 4 * PT_FLOATS;
static_assert(SMEM_BYTES <= 232448, "shared memory");
static_assert(4 * TM * LDP <= 4 * TM * LDH, "GP fits in S1|S2");
static_assert(2 * TM * (LDQ + LDS) <= 2 * TM * LDG, "GQ|GS fit in G");

template <int TK, int TN, int LDA, int LDW>
__device__ __forceinline__ void mm(const bf16* A, const bf16* __restrict__ W, float* C) {
  gfpp::tile_matmul<TM, NW, TK, TN, LDA, LDW, LDC>(A, W, C);
}

template <int TK, int TN, int LDA, int LDW, int LDA2 = LDA>
__device__ __forceinline__ void mm_wt(const bf16* A, const bf16* __restrict__ W, float* C,
                                      const bf16* A2 = nullptr, const bf16* __restrict__ W2 = nullptr) {
  gfpp::tile_matmul_wt<TM, NW, TK, TN, LDA, LDW, LDC, LDA2>(A, W, A2, W2, C);
}

// Operand O's tile at `tile` (ops' layout, fused_field_common.cuh):
// value(p, f) for point p < rows of the tile and feature f < OP_ROWS[O],
// zero for p >= rows. 16-byte chunk u of the tile's block is k16 step u /
// (2 R), core matrix (u % 2R) / 8 = (feature group j, point half h), row
// u % 8: features 8 j + u % 8, points 16 s + 8 h .. + 7.
template <int O, class Value>
__device__ __forceinline__ void store_operand(bf16* __restrict__ ops, int npad, int tile, int rows,
                                              Value&& value) {
  constexpr int R = gfpp::OP_ROWS[O];
  constexpr int FIRST = gfpp::op_first_row(O);
  uint4* dst = reinterpret_cast<uint4*>(ops + static_cast<size_t>(npad) * FIRST +
                                        static_cast<size_t>(tile) * TM * R);
  for (int u = threadIdx.x; u < TM * R / 8; u += NT) {
    const int s = u / (2 * R), cm = (u % (2 * R)) >> 3;
    const int f = (cm >> 1) * 8 + (u & 7), p0 = s * 16 + (cm & 1) * 8;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + 2 * e;
      const bf16 lo = p < rows ? value(p, f) : __float2bfloat16_rn(0.0f);
      const bf16 hi = p + 1 < rows ? value(p + 1, f) : __float2bfloat16_rn(0.0f);
      w[e] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
             (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
    }
    dst[u] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// the operand that is columns [c0, c0 + R) of a bf16 tile buffer (row stride ld)
template <int O>
__device__ __forceinline__ void store_cols(bf16* ops, int npad, int tile, int rows, const bf16* B, int ld,
                                           int c0 = 0) {
  store_operand<O>(ops, npad, tile, rows, [&](int p, int f) { return B[p * ld + c0 + f]; });
}

// the operand bf16(V[:, 0:3]) zero-padded to 8, from an f32 [TM, 3] tile
template <int O>
__device__ __forceinline__ void store_xyz3(bf16* ops, int npad, int tile, int rows, const float* V) {
  store_operand<O>(ops, npad, tile, rows, [&](int p, int f) {
    return __float2bfloat16_rn(f < 3 ? V[p * 3 + f] : 0.0f);
  });
}

// H[:, 0:128] = bf16(relu(C[:, 0:128] + bias)), bias optional
__device__ __forceinline__ void relu_to_bf16(const float* C, const float* __restrict__ bias, bf16* H) {
  for (int i = threadIdx.x; i < TM * 128; i += NT) {
    const int p = i >> 7, j = i & 127;
    float v = C[p * LDC + j];
    if (bias != nullptr) v += bias[j];
    H[p * LDH + j] = __float2bfloat16_rn(fmaxf(v, 0.0f));
  }
}

// D[:, 0:128] = bf16(C[:, 0:128] if act > 0 else 0): a gradient through ReLU
__device__ __forceinline__ void relu_grad_to_bf16(const float* C, const bf16* act, bf16* D, int ldd) {
  for (int i = threadIdx.x; i < TM * 128; i += NT) {
    const int p = i >> 7, j = i & 127;
    const bool on = __bfloat162float(act[p * LDH + j]) > 0.0f;
    D[p * ldd + j] = __float2bfloat16_rn(on ? C[p * LDC + j] : 0.0f);
  }
}

__global__ void __launch_bounds__(NT, 1) fused_field_bwd_kernel(
    const float* __restrict__ xyz,       // [n, 3]
    const float* __restrict__ dirs,      // [n, 3]
    int n, int ntiles,
    const float* __restrict__ g_sigma,   // [n]
    const float* __restrict__ g_rgb,     // [n, 3]
    const float* __restrict__ g_amb,     // [n, 3]
    const float* __restrict__ pos_B,     // [8, 128] f32
    const bf16* __restrict__ amb_w1,     // [384, 128]
    const bf16* __restrict__ amb_w2,     // [128, 128]
    const bf16* __restrict__ amb_w3,     // [128, 128]
    const float* __restrict__ amb_B,     // [128, 64] f32
    const bf16* __restrict__ sig_w1,     // [384, 128]
    const bf16* __restrict__ sig_w2,     // [128, 128]
    const bf16* __restrict__ sig_w3,     // [128, 256]
    const bf16* __restrict__ col_w1,     // [256, 128]
    const bf16* __restrict__ col_w2,     // [128, 128]
    const float* __restrict__ amb_bias,  // [128]
    const float* __restrict__ col_bias,  // [128]
    bf16* __restrict__ ops,              // the weight-gradient operands (Operand)
    int npad) {                          // points each operand holds: ntiles * TM
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* A1 = reinterpret_cast<bf16*>(smem + OFF_A1);
  bf16* A2 = reinterpret_cast<bf16*>(smem + OFF_A2);
  bf16* S1 = reinterpret_cast<bf16*>(smem + OFF_S1);
  bf16* S2 = reinterpret_cast<bf16*>(smem + OFF_S2);
  bf16* C1 = reinterpret_cast<bf16*>(smem + OFF_C1);
  bf16* G = reinterpret_cast<bf16*>(smem + OFF_G);
  bf16* GB = reinterpret_cast<bf16*>(smem + OFF_GB);
  float* C = reinterpret_cast<float*>(smem + OFF_C);
  float* PX = reinterpret_cast<float*>(smem + OFF_PT);
  float* PD = PX + TM * 3;
  float* PA = PD + TM * 3;    // ambient coordinate, f32
  float* PGR = PA + TM * 3;   // rgb output gradient
  float* PGA = PGR + TM * 3;  // ambient output gradient
  float* PGS = PGA + TM * 3;  // sigma output gradient
  float* PSG = PGS + TM;      // sigma
  float* PSL = PSG + TM;      // sigma logit
  // buffers reused once their first contents are dead
  float* GP = reinterpret_cast<float*>(smem + OFF_S1);  // position-Fourier gradient (S1|S2)
  bf16* GA = C1;                                        // g_a2, then g_a1
  bf16* GQ = G;                                         // bf16(g_aproj) [TM, 64]
  bf16* GS = G + TM * LDQ;                              // bf16(g_amb_logit) [TM, 16]

  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int base = tile * TM;
    const int rows = min(TM, n - base);

    // 0. stage the tile; rows past the ragged end read zeros
    for (int i = tid; i < TM * 3; i += NT) {
      const bool live = i < rows * 3;
      PX[i] = live ? xyz[base * 3 + i] : 0.0f;
      PD[i] = live ? dirs[base * 3 + i] : 0.0f;
      PGR[i] = live ? g_rgb[base * 3 + i] : 0.0f;
      PGA[i] = live ? g_amb[base * 3 + i] : 0.0f;
    }
    for (int p = tid; p < TM; p += NT) PGS[p] = p < rows ? g_sigma[base + p] : 0.0f;
    __syncthreads();

    // ---- forward recompute (fused_field.cu, step for step) ----
    for (int i = tid; i < TM * 128; i += NT) {
      const int p = i >> 7, f = i & 127;
      const float* x = PX + p * 3;
      const float proj = fmaf(x[2], pos_B[256 + f], fmaf(x[1], pos_B[128 + f], x[0] * pos_B[f]));
      X[p * LDX + f] = __float2bfloat16_rn(fast_sin(proj));
      X[p * LDX + 128 + f] = __float2bfloat16_rn(fast_cos(proj));
    }
    __syncthreads();
    mm<256, 128, LDX, 128>(X, amb_w1, C);
    __syncthreads();
    relu_to_bf16(C, amb_bias, A1);
    __syncthreads();
    mm<128, 128, LDH, 128>(A1, amb_w2, C);
    __syncthreads();
    relu_to_bf16(C, nullptr, A2);
    __syncthreads();
    mm<128, 16, LDH, 128>(A2, amb_w3, C);
    __syncthreads();
    for (int i = tid; i < TM * AMB; i += NT) PA[i] = fast_tanh(C[(i / AMB) * LDC + i % AMB]);
    __syncthreads();
    for (int i = tid; i < TM * 64; i += NT) {
      const int p = i >> 6, f = i & 63;
      const float* a = PA + p * AMB;
      const float proj = fmaf(a[2], amb_B[128 + f], fmaf(a[1], amb_B[64 + f], a[0] * amb_B[f]));
      X[p * LDX + 256 + f] = __float2bfloat16_rn(fast_sin(proj));
      X[p * LDX + 320 + f] = __float2bfloat16_rn(fast_cos(proj));
    }
    __syncthreads();
    mm<384, 128, LDX, 128>(X, sig_w1, C);
    __syncthreads();
    relu_to_bf16(C, nullptr, S1);
    __syncthreads();
    mm<128, 128, LDH, 128>(S1, sig_w2, C);
    __syncthreads();
    relu_to_bf16(C, nullptr, S2);
    __syncthreads();
    mm<128, 144, LDH, 256>(S2, sig_w3, C);
    __syncthreads();
    for (int p = tid; p < TM; p += NT) {
      PSL[p] = C[p * LDC];
      PSG[p] = expf(fminf(fmaxf(C[p * LDC], -15.0f), 15.0f));
    }
    for (int i = tid; i < TM * 128; i += NT) {
      const int p = i >> 7, j = i & 127;
      G[p * LDG + 16 + j] = __float2bfloat16_rn(C[p * LDC + 1 + j]);
    }
    for (int p = tid; p < TM; p += NT) gfpp::sh16(PD + p * 3, G + p * LDG);
    __syncthreads();
    mm<144, 128, LDG, 128>(G, col_w1, C);
    __syncthreads();
    relu_to_bf16(C, col_bias, C1);
    __syncthreads();
    mm<128, 16, LDH, 128>(C1, col_w2, C);
    __syncthreads();

    // ---- colour MLP ----
    // g_rgb_logit = bf16(g_rgb * rgb * (1 - rgb)), 16 columns, 3 live
    for (int i = tid; i < TM * 16; i += NT) {
      const int p = i >> 4, j = i & 15;
      float v = 0.0f;
      if (j < 3) {
        const float rgb = 1.0f / (1.0f + expf(-C[p * LDC + j]));
        v = PGR[p * 3 + j] * rgb * (1.0f - rgb);
      }
      GB[p * LDG + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    // operands go out while their buffers hold them: C1, S1|S2 and G are
    // reused for gradients later in the tile, X, A1 and A2 are not
    store_cols<gfpp::OP_GRGB>(ops, npad, tile, rows, GB, LDG);
    store_cols<gfpp::OP_C1>(ops, npad, tile, rows, C1, LDH);
    store_cols<gfpp::OP_S2>(ops, npad, tile, rows, S2, LDH);
    store_cols<gfpp::OP_S1>(ops, npad, tile, rows, S1, LDH);
    store_operand<gfpp::OP_G>(ops, npad, tile, rows, [&](int p, int f) {  // [geo | SH]
      return G[p * LDG + (f < 128 ? 16 + f : f - 128)];
    });
    mm_wt<16, 128, LDG, 128>(GB, col_w2, C);
    __syncthreads();
    relu_grad_to_bf16(C, C1, GB, LDG);  // g_c1
    __syncthreads();
    store_cols<gfpp::OP_GC1A>(ops, npad, tile, rows, GB, LDG);
    store_cols<gfpp::OP_GC1B>(ops, npad, tile, rows, GB, LDG, 64);
    mm_wt<128, 128, LDG, 128>(GB, col_w1 + 16 * 128, C);  // g_geo
    __syncthreads();

    // ---- sigma MLP ----
    // g_sig_out = bf16([g_sigma * sigma (logit in range) | g_geo | 0]), 144 columns
    for (int i = tid; i < TM * 144; i += NT) {
      const int p = i / 144, j = i % 144;
      float v = 0.0f;
      if (j == 0) {
        const float l = PSL[p];
        v = (l > -15.0f && l < 15.0f) ? PGS[p] * PSG[p] : 0.0f;
      } else if (j <= 128) {
        v = C[p * LDC + j - 1];
      }
      GB[p * LDG + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    store_operand<gfpp::OP_GSIG>(ops, npad, tile, rows, [&](int p, int f) {  // [g_geo | g_sigma_logit | 0]
      return f < 128 ? GB[p * LDG + 1 + f] : f == 128 ? GB[p * LDG] : __float2bfloat16_rn(0.0f);
    });
    mm_wt<144, 128, LDG, 256>(GB, sig_w3, C);
    __syncthreads();
    relu_grad_to_bf16(C, S2, GB, LDG);  // g_s2
    __syncthreads();
    store_cols<gfpp::OP_GS2>(ops, npad, tile, rows, GB, LDG);
    mm_wt<128, 128, LDG, 128>(GB, sig_w2, C);
    __syncthreads();
    relu_grad_to_bf16(C, S1, GB, LDG);  // g_s1
    __syncthreads();
    store_cols<gfpp::OP_GS1>(ops, npad, tile, rows, GB, LDG);
    mm_wt<128, 128, LDG, 128>(GB, sig_w1 + 256 * 128, C);  // g_amb_feat
    __syncthreads();

    // ---- ambient Fourier features and tanh ----
    for (int i = tid; i < TM * 64; i += NT) {
      const int p = i >> 6, f = i & 63;
      const float* a = PA + p * AMB;
      const float proj = fmaf(a[2], amb_B[128 + f], fmaf(a[1], amb_B[64 + f], a[0] * amb_B[f]));
      const float v = C[p * LDC + f] * fast_cos(proj) - C[p * LDC + 64 + f] * fast_sin(proj);
      GQ[p * LDQ + f] = __float2bfloat16_rn(v);  // g_aproj
    }
    __syncthreads();
    store_cols<gfpp::OP_GAPROJ>(ops, npad, tile, rows, GQ, LDQ);
    store_xyz3<gfpp::OP_APOS>(ops, npad, tile, rows, PA);
    // g_amb_logit = bf16((bf16(g_aproj) . bf16(amb_B)^T + g_amb) * (1 - amb_pos^2)), 16 columns, 3 live
    for (int i = tid; i < TM * 16; i += NT) {
      const int p = i >> 4, j = i & 15;
      float v = 0.0f;
      if (j < AMB) {
        float s = 0.0f;
        for (int f = 0; f < 64; ++f) s = fmaf(__bfloat162float(GQ[p * LDQ + f]), bf16_round(amb_B[j * 64 + f]), s);
        const float a = PA[p * AMB + j];
        v = (s + PGA[p * AMB + j]) * (1.0f - a * a);
      }
      GS[p * LDS + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();

    // ---- ambient MLP ----
    store_cols<gfpp::OP_GAMB>(ops, npad, tile, rows, GS, LDS);
    mm_wt<16, 128, LDS, 128>(GS, amb_w3, C);
    __syncthreads();
    relu_grad_to_bf16(C, A2, GA, LDH);  // g_a2
    __syncthreads();
    store_cols<gfpp::OP_GA2>(ops, npad, tile, rows, GA, LDH);
    mm_wt<128, 128, LDH, 128>(GA, amb_w2, C);
    __syncthreads();
    relu_grad_to_bf16(C, A1, GA, LDH);  // g_a1
    __syncthreads();
    store_cols<gfpp::OP_GA1>(ops, npad, tile, rows, GA, LDH);
    store_cols<gfpp::OP_X0>(ops, npad, tile, rows, X, LDX);
    store_cols<gfpp::OP_X1>(ops, npad, tile, rows, X, LDX, 64);
    store_cols<gfpp::OP_X2>(ops, npad, tile, rows, X, LDX, 128);
    store_cols<gfpp::OP_X3>(ops, npad, tile, rows, X, LDX, 192);
    store_cols<gfpp::OP_XA>(ops, npad, tile, rows, X, LDX, 256);
    store_cols<gfpp::OP_A1>(ops, npad, tile, rows, A1, LDH);
    store_cols<gfpp::OP_A2>(ops, npad, tile, rows, A2, LDH);

    // ---- position Fourier features ----
    // g_pos_feat = g_s1 . sig_w1p^T + g_a1 . amb_w1p^T, in its sin and cos halves;
    // g_proj = g_pos_feat[:, :128] * cos_p - g_pos_feat[:, 128:] * sin_p
    mm_wt<128, 128, LDG, 128, LDH>(GB, sig_w1, C, GA, amb_w1);
    __syncthreads();
    for (int i = tid; i < TM * 128; i += NT) {
      const int p = i >> 7, f = i & 127;
      const float* x = PX + p * 3;
      const float proj = fmaf(x[2], pos_B[256 + f], fmaf(x[1], pos_B[128 + f], x[0] * pos_B[f]));
      GP[p * LDP + f] = C[p * LDC + f] * fast_cos(proj);
    }
    __syncthreads();
    mm_wt<128, 128, LDG, 128, LDH>(GB, sig_w1 + 128 * 128, C, GA, amb_w1 + 128 * 128);
    __syncthreads();
    for (int i = tid; i < TM * 128; i += NT) {
      const int p = i >> 7, f = i & 127;
      const float* x = PX + p * 3;
      const float proj = fmaf(x[2], pos_B[256 + f], fmaf(x[1], pos_B[128 + f], x[0] * pos_B[f]));
      GB[p * LDG + f] = __float2bfloat16_rn(GP[p * LDP + f] - C[p * LDC + f] * fast_sin(proj));
    }
    __syncthreads();
    store_cols<gfpp::OP_GPROJ>(ops, npad, tile, rows, GB, LDG);
    store_xyz3<gfpp::OP_XYZB>(ops, npad, tile, rows, PX);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int gfpp_fused_field_bwd_operand_rows() { return gfpp::OPERAND_ROWS; }

// Launches the tile chain on `stream` and returns cudaGetLastError() (0 on
// success). `ops` receives the weight-gradient operands: npad *
// OPERAND_ROWS bf16, npad = n rounded up to the 64-point tile.
int gfpp_fused_field_backward(const void* xyz, const void* dirs, int n, const void* g_sigma,
                              const void* g_rgb, const void* g_amb, const void* pos_B,
                              const void* amb_w1, const void* amb_w2, const void* amb_w3,
                              const void* amb_B, const void* sig_w1, const void* sig_w2,
                              const void* sig_w3, const void* col_w1, const void* col_w2,
                              const void* amb_bias, const void* col_bias, void* ops, int npad,
                              int nblocks, void* stream) {
  const int ntiles = (n + TM - 1) / TM;
  if (n <= 0 || nblocks <= 0 || npad != ntiles * TM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_field_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nblocks > ntiles) nblocks = ntiles;
  fused_field_bwd_kernel<<<nblocks, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(dirs), n, ntiles,
      static_cast<const float*>(g_sigma), static_cast<const float*>(g_rgb),
      static_cast<const float*>(g_amb), static_cast<const float*>(pos_B),
      static_cast<const bf16*>(amb_w1), static_cast<const bf16*>(amb_w2),
      static_cast<const bf16*>(amb_w3), static_cast<const float*>(amb_B),
      static_cast<const bf16*>(sig_w1), static_cast<const bf16*>(sig_w2),
      static_cast<const bf16*>(sig_w3), static_cast<const bf16*>(col_w1),
      static_cast<const bf16*>(col_w2), static_cast<const float*>(amb_bias),
      static_cast<const float*>(col_bias), static_cast<bf16*>(ops), npad);
  return static_cast<int>(cudaGetLastError());
}

const char* gfpp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
