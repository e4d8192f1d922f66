// Fused RAD-NeRF head-field backward for Hopper (sm_90a): the tile chain.
//
// Replaces, with the forward's train mode (fused_field.cu) and
// fused_field_wgrad.cu, the TPU kernel
// genefaceplusplus_tpu/ops/pallas/fused_field.py:_bwd_kernel (launched by
// _fused_backward, pallas_call at :423, under fused_field_train). The
// Pallas kernel recomputes the forward per tile; here the forward kernel's
// train mode has already written the activation operands, the five hidden
// layers' ReLU masks and the sigma gate, and this kernel only
// backpropagates. Per tile of points it reads B1's outputs (sigma, rgb and
// the ambient coordinate, f32), the gate, the masks, xyz and the output
// gradients (sigma, rgb, ambient coordinate), backpropagates them through
// the colour, sigma and ambient MLPs and both Fourier projections, and
// writes the gradient half of the weight-gradient operands
// (fused_field_common.cuh, CHAIN_OPERANDS: 984 bf16 rows a point) into the
// operand buffer beside the train mode's activation half. Which kernel
// writes which operand is the common header's TRAIN_OPERANDS /
// CHAIN_OPERANDS (ops/fused_field.py, OPERAND_WRITERS).
// fused_field_wgrad.cu then sums the products over all points.
//
// What bounds it on an H100: bytes. Its ten input-gradient products are
// 148,544 bf16 multiply-adds a point (0.315 ms at 1,048,576 points),
// against 1,968 operand bytes a point written, 80 bytes of masks, 1 of
// gate and 68 of point data read (xyz, sigma, rgb, amb, three output
// gradients): 0.663 ms at 1,048,576 points.
//
// Design:
// * Why two kernels after the forward. The Pallas kernel adds every
//   tile's weight gradients into one VMEM accumulator, which relies on the
//   TPU grid running in order on one core. The 14 gradient blocks (605 KB
//   of f32) fit neither in an SM's shared memory nor in its registers, so a
//   one-kernel port reads and rewrites a per-block f32 partial for every
//   64 points. Here the forward's train mode and the chain write the bf16
//   operands once, and the weight-gradient kernel keeps its sums in
//   registers over thousands of points.
// * No forward. The chain's only products are the input gradients g . W^T
//   (WMMA m16n16k16, B fragments straight from L2). The position and
//   ambient Fourier phases are recomputed once each, in f32, by the
//   forward's FMA chain, for their sin/cos derivatives.
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
// * The ragged last tile. Rows past n read zero output gradients (and zero
//   masks and point data), so every gradient they touch is exactly zero.
// * Rounding and derivatives as the Pallas kernel has them. g_rgb_logit,
//   g_c1, g_sig_out, g_s2, g_s1, g_amb_logit, g_a2 and g_a1 round to bf16 (the
//   tensor-core inputs); a ReLU mask is the forward's bf16 activation > 0
//   (equal to relu(x) > 0 unless x < 2^-134); sin/cos derivatives use fast_cos/fast_sin of the
//   recomputed phases, tanh's is 1 - amb_pos^2; amb_B, amb_pos, g_aproj,
//   xyz and g_proj round to bf16 for their products; the sigma gradient is
//   gated to logits in (-15, 15) (the forward's gate).
// * The position-Fourier gradient rounds as the forward-recomputing chain
//   did (the sin half's product on its own, then one fused multiply-add),
//   so the gradients are that chain's bit for bit (chip_smoke.py's
//   kernel_bwd phase compares them with the parent tree's).
// * Shared memory (114,176 bytes, two blocks of 8 warps an SM): two f32
//   product tiles (the position-Fourier gradient's sin and cos halves; the
//   second holds the ambient-Fourier gradients before that), the bf16
//   gradient tile, the bf16 ambient-gradient tile, the masks and the point
//   data.
//
// Build (no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_field_bwd.so fused_field_bwd.cu

#include "fused_field_common.cuh"

using gfpp::bf16;
using gfpp::bf16_round;
using gfpp::fast_cos;
using gfpp::fast_sin;

namespace {

constexpr int TM = 64;  // points per tile
constexpr int NW = 8;   // warps per block
constexpr int NT = 32 * NW;
constexpr int BLOCKS_PER_SM = 2;
constexpr int AMB = 3;

constexpr int LDC = 132;  // f32 product tile
constexpr int LDG = 152;  // bf16 gradient tile (K <= 144)
constexpr int LDH = 136;  // bf16 ambient-MLP gradient tile
constexpr int LDQ = 72;   // bf16 ambient-Fourier gradient
constexpr int LDS = 24;   // bf16 ambient-logit gradient

constexpr int OFF_C2 = 4 * TM * LDC;
constexpr int OFF_GB = OFF_C2 + 4 * TM * LDC;
constexpr int OFF_GA = OFF_GB + 2 * TM * LDG;
constexpr int OFF_M = OFF_GA + 2 * TM * LDH;
constexpr int OFF_PT = OFF_M + 4 * gfpp::RELU_LAYERS * TM * gfpp::RELU_WORDS;
constexpr int PT_FLOATS = TM * (3 + 1 + 3 + 3 + 1 + 1 + 3 + 3);
constexpr int SMEM_BYTES = OFF_PT + 4 * PT_FLOATS;
// two blocks an SM: 228 KB, less 1 KB the system reserves for each block
static_assert(BLOCKS_PER_SM * (SMEM_BYTES + 1024) <= 233472, "shared memory");
static_assert(2 * TM * (LDQ + LDS) <= 4 * TM * LDC, "GQ|GS fit in C2");
static_assert(OFF_C2 % 32 == 0 && OFF_GB % 32 == 0 && OFF_GA % 32 == 0 && OFF_M % 32 == 0, "WMMA alignment");

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
  static_assert(gfpp::listed(O, gfpp::CHAIN_OPERANDS), "the chain writes the gradient operands");
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

// D[:, 0:128] = bf16(C[:, 0:128] if layer l's ReLU was on else 0): a
// gradient through ReLU, the mask from M ([RELU_LAYERS][TM][RELU_WORDS])
__device__ __forceinline__ void relu_grad_to_bf16(const float* C, const uint32_t* M, int l, bf16* D, int ldd) {
  for (int i = threadIdx.x; i < TM * 128; i += NT) {
    const int p = i >> 7, j = i & 127;
    const uint32_t word = M[(l * TM + p) * gfpp::RELU_WORDS + gfpp::relu_word(j)];
    const bool on = (word >> gfpp::relu_bit(j)) & 1u;
    D[p * ldd + j] = __float2bfloat16_rn(on ? C[p * LDC + j] : 0.0f);
  }
}

enum ReluLayer { RELU_A1, RELU_A2, RELU_S1, RELU_S2, RELU_C1 };

__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) fused_field_bwd_kernel(
    const float* __restrict__ xyz,           // [n, 3]
    const float* __restrict__ sigma,         // [n]     the forward's outputs
    const float* __restrict__ rgb,           // [n, 3]
    const float* __restrict__ amb,           // [n, 3]
    const unsigned char* __restrict__ gate,  // [n]     1 where the sigma logit is in (-15, 15)
    const uint32_t* __restrict__ relu,       // [RELU_LAYERS, npad, RELU_WORDS] ReLU masks
    int n, int ntiles,
    const float* __restrict__ g_sigma,       // [n]
    const float* __restrict__ g_rgb,         // [n, 3]
    const float* __restrict__ g_amb,         // [n, 3]
    const float* __restrict__ pos_B,         // [8, 128] f32
    const bf16* __restrict__ amb_w1,         // [384, 128]
    const bf16* __restrict__ amb_w2,         // [128, 128]
    const bf16* __restrict__ amb_w3,         // [128, 128]
    const float* __restrict__ amb_B,         // [128, 64] f32
    const bf16* __restrict__ sig_w1,         // [384, 128]
    const bf16* __restrict__ sig_w2,         // [128, 128]
    const bf16* __restrict__ sig_w3,         // [128, 256]
    const bf16* __restrict__ col_w1,         // [256, 128]
    const bf16* __restrict__ col_w2,         // [128, 128]
    bf16* __restrict__ ops,                  // the weight-gradient operands (CHAIN_OPERANDS' rows)
    int npad) {                              // points each operand holds: ntiles * TM
  extern __shared__ __align__(128) unsigned char smem[];
  float* C = reinterpret_cast<float*>(smem);
  float* C2 = reinterpret_cast<float*>(smem + OFF_C2);
  bf16* GB = reinterpret_cast<bf16*>(smem + OFF_GB);
  bf16* GA = reinterpret_cast<bf16*>(smem + OFF_GA);  // g_a2, then g_a1
  uint32_t* M = reinterpret_cast<uint32_t*>(smem + OFF_M);
  float* PX = reinterpret_cast<float*>(smem + OFF_PT);  // xyz
  float* PSG = PX + TM * 3;   // sigma
  float* PR = PSG + TM;       // rgb
  float* PA = PR + TM * 3;    // ambient coordinate
  float* PGT = PA + TM * 3;   // sigma gate, 0 or 1
  float* PGS = PGT + TM;      // sigma output gradient
  float* PGR = PGS + TM;      // rgb output gradient
  float* PGA = PGR + TM * 3;  // ambient output gradient
  bf16* GQ = reinterpret_cast<bf16*>(C2);  // bf16(g_aproj) [TM, 64], while C2 is free
  bf16* GS = GQ + TM * LDQ;                // bf16(g_amb_logit) [TM, 16]

  const int tid = threadIdx.x;

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int base = tile * TM;
    const int rows = min(TM, n - base);

    // 0. stage the tile; rows past the ragged end read zeros
    for (int i = tid; i < TM * 3; i += NT) {
      const bool live = i < rows * 3;
      PX[i] = live ? xyz[base * 3 + i] : 0.0f;
      PR[i] = live ? rgb[base * 3 + i] : 0.0f;
      PA[i] = live ? amb[base * 3 + i] : 0.0f;
      PGR[i] = live ? g_rgb[base * 3 + i] : 0.0f;
      PGA[i] = live ? g_amb[base * 3 + i] : 0.0f;
    }
    for (int p = tid; p < TM; p += NT) {
      const bool live = p < rows;
      PSG[p] = live ? sigma[base + p] : 0.0f;
      PGT[p] = live && gate[base + p] ? 1.0f : 0.0f;
      PGS[p] = live ? g_sigma[base + p] : 0.0f;
    }
    for (int i = tid; i < gfpp::RELU_LAYERS * TM * gfpp::RELU_WORDS; i += NT) {
      const int l = i / (TM * gfpp::RELU_WORDS), r = i % (TM * gfpp::RELU_WORDS);
      M[i] = r < rows * gfpp::RELU_WORDS ? relu[(static_cast<size_t>(l) * npad + base) * gfpp::RELU_WORDS + r] : 0u;
    }
    __syncthreads();

    // ---- colour MLP ----
    // g_rgb_logit = bf16(g_rgb * rgb * (1 - rgb)), 16 columns, 3 live
    for (int i = tid; i < TM * 16; i += NT) {
      const int p = i >> 4, j = i & 15;
      float v = 0.0f;
      if (j < 3) {
        const float c = PR[p * 3 + j];
        v = PGR[p * 3 + j] * c * (1.0f - c);
      }
      GB[p * LDG + j] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    store_cols<gfpp::OP_GRGB>(ops, npad, tile, rows, GB, LDG);
    mm_wt<16, 128, LDG, 128>(GB, col_w2, C);
    __syncthreads();
    relu_grad_to_bf16(C, M, RELU_C1, GB, LDG);  // g_c1
    __syncthreads();
    store_cols<gfpp::OP_GC1A>(ops, npad, tile, rows, GB, LDG);
    store_cols<gfpp::OP_GC1B>(ops, npad, tile, rows, GB, LDG, 64);
    mm_wt<128, 128, LDG, 128>(GB, col_w1 + 16 * 128, C);  // g_geo
    __syncthreads();

    // ---- sigma MLP ----
    // g_sig_out = bf16([g_sigma * sigma (gated) | g_geo | 0]), 144 columns
    for (int i = tid; i < TM * 144; i += NT) {
      const int p = i / 144, j = i % 144;
      float v = 0.0f;
      if (j == 0) {
        v = PGT[p] != 0.0f ? PGS[p] * PSG[p] : 0.0f;
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
    relu_grad_to_bf16(C, M, RELU_S2, GB, LDG);  // g_s2
    __syncthreads();
    store_cols<gfpp::OP_GS2>(ops, npad, tile, rows, GB, LDG);
    mm_wt<128, 128, LDG, 128>(GB, sig_w2, C);
    __syncthreads();
    relu_grad_to_bf16(C, M, RELU_S1, GB, LDG);  // g_s1, kept to the end of the tile
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
    relu_grad_to_bf16(C, M, RELU_A2, GA, LDH);  // g_a2
    __syncthreads();
    store_cols<gfpp::OP_GA2>(ops, npad, tile, rows, GA, LDH);
    mm_wt<128, 128, LDH, 128>(GA, amb_w2, C);
    __syncthreads();
    relu_grad_to_bf16(C, M, RELU_A1, GA, LDH);  // g_a1
    __syncthreads();
    store_cols<gfpp::OP_GA1>(ops, npad, tile, rows, GA, LDH);

    // ---- position Fourier features ----
    // g_pos_feat = g_s1 . sig_w1p^T + g_a1 . amb_w1p^T, its sin half into C
    // and its cos half into C2; g_proj = g_pos_feat[:, :128] * cos_p -
    // g_pos_feat[:, 128:] * sin_p, the phase computed once
    mm_wt<128, 128, LDG, 128, LDH>(GB, sig_w1, C, GA, amb_w1);
    mm_wt<128, 128, LDG, 128, LDH>(GB, sig_w1 + 128 * 128, C2, GA, amb_w1 + 128 * 128);
    __syncthreads();
    for (int i = tid; i < TM * 128; i += NT) {
      const int p = i >> 7, f = i & 127;
      const float* x = PX + p * 3;
      const float proj = fmaf(x[2], pos_B[256 + f], fmaf(x[1], pos_B[128 + f], x[0] * pos_B[f]));
      // the sin half's product rounded on its own, then one fused multiply-add
      const float sin_half = __fmul_rn(C[p * LDC + f], fast_cos(proj));
      GB[p * LDG + f] = __float2bfloat16_rn(__fmaf_rn(-C2[p * LDC + f], fast_sin(proj), sin_half));
    }
    __syncthreads();
    store_cols<gfpp::OP_GPROJ>(ops, npad, tile, rows, GB, LDG);
    __syncthreads();
  }
}

}  // namespace

extern "C" {

int gfpp_fused_field_bwd_operand_rows() { return gfpp::OPERAND_ROWS; }

// The operands the chain writes (CHAIN_OPERANDS, as Operand indices) into
// `out`; returns their number.
int gfpp_fused_field_bwd_operands(int* out, int cap) {
  for (int i = 0; i < gfpp::N_CHAIN_OPERANDS && i < cap; ++i) out[i] = gfpp::CHAIN_OPERANDS[i];
  return gfpp::N_CHAIN_OPERANDS;
}

// Launches the tile chain on `stream` (BLOCKS_PER_SM persistent blocks an
// SM) and returns cudaGetLastError() (0 on success). sigma, rgb, amb, gate
// and relu are the forward's train mode's; `ops` is the operand buffer the
// train mode wrote (npad * OPERAND_ROWS bf16, npad = n rounded up to the
// 64-point tile), which receives CHAIN_OPERANDS' rows.
int gfpp_fused_field_backward(const void* xyz, const void* sigma, const void* rgb, const void* amb,
                              const void* gate, const void* relu, int n, const void* g_sigma,
                              const void* g_rgb, const void* g_amb, const void* pos_B,
                              const void* amb_w1, const void* amb_w2, const void* amb_w3,
                              const void* amb_B, const void* sig_w1, const void* sig_w2,
                              const void* sig_w3, const void* col_w1, const void* col_w2,
                              void* ops, int npad, void* stream) {
  const int ntiles = (n + TM - 1) / TM;
  if (n <= 0 || npad != ntiles * TM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_field_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_field_bwd_kernel, NT, SMEM_BYTES)) !=
      cudaSuccess)
    return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int nblocks = ntiles < sms * per_sm ? ntiles : sms * per_sm;
  fused_field_bwd_kernel<<<nblocks, NT, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(sigma), static_cast<const float*>(rgb),
      static_cast<const float*>(amb), static_cast<const unsigned char*>(gate),
      static_cast<const uint32_t*>(relu), n, ntiles, static_cast<const float*>(g_sigma),
      static_cast<const float*>(g_rgb), static_cast<const float*>(g_amb), static_cast<const float*>(pos_B),
      static_cast<const bf16*>(amb_w1), static_cast<const bf16*>(amb_w2),
      static_cast<const bf16*>(amb_w3), static_cast<const float*>(amb_B),
      static_cast<const bf16*>(sig_w1), static_cast<const bf16*>(sig_w2),
      static_cast<const bf16*>(sig_w3), static_cast<const bf16*>(col_w1),
      static_cast<const bf16*>(col_w2), static_cast<bf16*>(ops), npad);
  return static_cast<int>(cudaGetLastError());
}

// Blocks an SM the chain is built for, and its dynamic shared memory a block.
int gfpp_fused_field_bwd_config(int* blocks_per_sm, int* smem_bytes) {
  *blocks_per_sm = BLOCKS_PER_SM;
  *smem_bytes = SMEM_BYTES;
  return 0;
}

const char* gfpp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
