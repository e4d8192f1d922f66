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
// What bounds it on an H100: bytes. Its input-gradient products are
// 148,544 bf16 multiply-adds a point at their live widths (0.315 ms at
// 1,048,576 points), against 1,968 operand bytes a point written, 80 bytes
// of masks, 1 of gate and 68 of point data read (xyz, sigma, rgb, amb,
// three output gradients): 0.663 ms at 1,048,576 points.
//
// Design, B1's (fused_field.cu) turned around:
// * Products. Every input gradient g . W^T is a warpgroup product (wgmma
//   m64n128k16, bf16 in, f32 sums), one consumer warpgroup per 64-point
//   tile. Its B operand (N = the layer's input features, K = its output
//   features) is the live block of W itself in the K-major layout, packed
//   on the host in the order the products read it (ops/fused_field.py,
//   CHAIN_LAYERS, pack_chain_weights; this file's SPEC, compared when the
//   library loads): about 300 KB, streamed from L2 with bulk copies by one
//   producer thread into a ring of NSTAGE shared-memory stages (mbarriers
//   full/empty). Every consumer warpgroup reads each staged chunk. The
//   ring (Ring, layer, produce) is B1's, kept as a copy here so that B1's
//   serving code stays as it is.
// * A from registers. A gradient's f32 accumulator gets its ReLU mask and
//   bf16 rounding in registers and is the next product's A fragment
//   (sm90.cuh). The mask words are in the accumulator's layout: lane t of a
//   row quad reads word t of rows g and g + 8 (fused_field_common.cuh,
//   relu_word). g_rgb_logit and g_amb_logit are computed straight into A
//   fragments; g_amb_logit's 64-wide dot with bf16(amb_B) is a reduction
//   over the row quad's lanes by shuffles, k ascending f = 0..63 in one
//   fmaf chain. g_s1 stays in registers from the sigma MLP to the position
//   products, g_a1 from the ambient MLP; with the accumulator that is 128
//   registers at the position step, inside the consumers' 160.
// * No barrier but the ring's, and no shared memory but the ring, the
//   Fourier matrices and the mbarriers: the ambient- and position-Fourier
//   gradients pair column c with column c + 64 of one accumulator, which
//   one thread holds. For the position gradient the stream orders each N =
//   128 half as 64 sin features, then the same 64 cos features
//   (CHAIN_LAYERS' pos_lo / pos_hi), so g_proj = g_sin . cos - g_cos . sin
//   needs no exchange; g_amb_feat's columns f and 64 + f already pair so.
// * sig_w3's K order. The product that takes g_sig_out = [g_sigma | g_geo
//   | 0] (144 wide) keeps the Pallas kernel's order, sigma's column first,
//   so its f32 sums are those of the tile chain this kernel replaced, which
//   summed the same k16 steps in the same order (chip_smoke.py holds the
//   gradients to that chain's, PARENT_REFERENCE). The A fragment of column
//   c is g_geo's accumulator column c - 1, which the row quad's left
//   neighbour holds (lane t - 1, or lane 3 of the block before for t = 0):
//   one shuffle a block and row. Reordering K to [g_geo | g_sigma | 0] (as
//   B1 packs sig_w3 and as the gsig operand is) would need no shuffle but
//   would add sigma's term last: another f32 sum.
// * Stores. The gradient operands go out through movmatrix.trans from the
//   fragments (fused_field_common.cuh, store_fragments), each layer's after
//   the products that read its registers. gsig and gproj go out from the
//   accumulator, gsig before the product that overwrites it.
// * Occupancy: one block an SM of one producer warpgroup (setmaxnreg down
//   to 24) and NCONS = 3 consumer warpgroups (up to 160 registers), a ring
//   of NSTAGE = 6 stages of 16 KB. -Xptxas -v must report no spill
//   (chip_smoke.py's build and kernel_bwd phases check).
// Measured on an H100 (PERF.md; chip_smoke.py, tools/chain_variants.py):
// 0.98-1.18 ms at 1,048,576 points, 56-68 % of the bound. With two
// consumer warpgroups (232 registers each) it took 1.16-1.20 ms: a third
// consumer shares each streamed weight chunk among 192 points instead of
// 128 and covers the others' CUDA-core epilogues; with 10 or 13 stages
// instead of 6, 1.07-1.08 ms.
// * The ragged tile. Rows past n load zeros (masks, gate, point data and
//   output gradients), so every gradient they touch is exactly zero, and
//   they are written as zeros; a consumer tile that lies wholly past n (the
//   last block step's) computes on zeros and writes nothing, so every
//   consumer walks the ring for every step.
// * Rounding and derivatives as the Pallas kernel has them. g_rgb_logit,
//   g_c1, g_sig_out, g_s2, g_s1, g_amb_logit, g_a2 and g_a1 round to bf16 (the
//   tensor-core inputs); a ReLU mask is the forward's bf16 activation > 0
//   (equal to relu(x) > 0 unless x < 2^-134); sin/cos derivatives use fast_cos/fast_sin of the
//   recomputed phases, tanh's is 1 - amb_pos^2; amb_B, amb_pos, g_aproj,
//   xyz and g_proj round to bf16 for their products; the sigma gradient is
//   gated to logits in (-15, 15) (the forward's gate). g_pos_feat sums the
//   g_s1 pass over all its k steps, then the g_a1 pass, into one
//   accumulator. The position-Fourier gradient rounds the sin half's
//   product on its own, then one fused multiply-add.
//
// Build (no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_field_bwd.so fused_field_bwd.cu

#include "fused_field_common.cuh"
#include "sm90.cuh"

using gfpp::bf16;
using gfpp::fast_cos;
using gfpp::fast_sin;
using gfpp::store_fragment;
using gfpp::store_fragments;
using namespace gfpp::sm90;

namespace {

constexpr int TM = 64;     // points per consumer warpgroup
constexpr int NCONS = 3;   // consumer warpgroups sharing each weight chunk
constexpr int NTHREAD = 128 * (1 + NCONS);  // warpgroup 0 produces
constexpr int NSTAGE = 6;   // weight ring depth
// registers: each thread starts with the launch bound's share (128 a thread
// at 512 threads); the producers give theirs down to 24, the consumers take
// them (160)
constexpr int LAUNCH_REGS = 65536 / NTHREAD / 8 * 8, PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = (65536 - 128 * PRODUCER_REGS) / (128 * NCONS) / 8 * 8;
static_assert(CONSUMER_REGS >= LAUNCH_REGS && CONSUMER_REGS <= 256, "register split");

// The packed weight stream, in the order the products read it: each
// product's B operand (N rows x K, K-major, sm90.cuh layout), cut into
// chunks of whole k16 steps. {k16 steps, N, k16 steps per chunk};
// ops/fused_field.py's CHAIN_LAYERS is the same table (checked when the
// library loads).
constexpr int NLAYER = 9;
constexpr int SPEC[NLAYER][3] = {
    {1, 128, 1},   // col_w2 columns 0..2, K zero-padded to 16: g_rgb_logit -> g_c1
    {8, 128, 4},   // col_w1 rows 16..143: g_c1 -> g_geo
    {9, 128, 3},   // sig_w3 columns 0..128, K zero-padded to 144: [g_sigma | g_geo | 0] -> g_s2
    {8, 128, 4},   // sig_w2: g_s2 -> g_s1
    {8, 128, 4},   // sig_w1 rows 256..383: g_s1 -> g_amb_feat
    {1, 128, 1},   // amb_w3 columns 0..2, K zero-padded to 16: g_amb_logit -> g_a2
    {8, 128, 4},   // amb_w2: g_a2 -> g_a1
    {16, 128, 4},  // pos_feat 0..63 | 128..191: sig_w1 rows, then amb_w1 rows (g_s1, then g_a1)
    {16, 128, 4},  // pos_feat 64..127 | 192..255, the same
};
enum ChainLayer { L_COL_W2, L_COL_W1, L_SIG_W3, L_SIG_W2, L_SIG_W1A, L_AMB_W3, L_AMB_W2, L_POS_LO, L_POS_HI };

template <int L>
struct Layer {
  static constexpr int ksteps = SPEC[L][0], n = SPEC[L][1], chunk = SPEC[L][2];
  static constexpr int nchunk = ksteps / chunk;
  static constexpr int kstep_bytes = n * 32, chunk_bytes = chunk * kstep_bytes;
  static_assert(ksteps % chunk == 0, "whole chunks");
  static_assert(n == 128, "every product is m64n128");
};

constexpr int STAGE_BYTES = 4 * 128 * 32;  // the largest chunk, 16,384 bytes
constexpr int PARAM_FLOATS = 3 * 128 + 3 * 64 + 3 * 64;  // pos_B, amb_B, bf16(amb_B): rows 0..2
constexpr int OFF_PARAM = NSTAGE * STAGE_BYTES;
constexpr int OFF_BAR = OFF_PARAM + PARAM_FLOATS * 4;
constexpr int SMEM_BYTES = OFF_BAR + 2 * NSTAGE * 8;
static_assert(STAGE_BYTES % 128 == 0 && OFF_BAR % 8 == 0, "alignment");
static_assert(SMEM_BYTES <= 232448, "shared memory");

constexpr int stage_fits() {
  for (int l = 0; l < NLAYER; ++l)
    if (SPEC[l][2] * SPEC[l][1] * 32 > STAGE_BYTES) return false;
  return true;
}
static_assert(stage_fits(), "every chunk fits a stage");

// the ring's read side, as one consumer warpgroup walks it
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;  // shared address of stage 0
  int stage, prev;
  uint32_t phase;

  __device__ __forceinline__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);  // one arrival per warp
  }
  __device__ __forceinline__ void advance() {
    prev = stage;
    if (++stage == NSTAGE) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// One product: for each chunk, wait for it, start its k steps
// (products(k, B descriptor address)), and release the previous chunk's
// stage once its products have completed. Returns with every product done.
template <int L, class Products>
__device__ __forceinline__ void layer(Ring& r, Products&& products) {
  using S = Layer<L>;
#pragma unroll
  for (int c = 0; c < S::nchunk; ++c) {
    mbar_wait(&r.full[r.stage], r.phase);
    const uint32_t b = r.base + r.stage * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::chunk; ++kk) products(c * S::chunk + kk, b + kk * S::kstep_bytes);
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();
      r.release(r.prev);
    }
    r.advance();
  }
  wgmma_wait<0>();
  r.release(r.prev);
}

// The producer's side of one product: each chunk into the next free stage.
template <int L>
__device__ __forceinline__ void produce(const unsigned char*& src, unsigned char* stages, uint64_t* full,
                                        uint64_t* empty, int& stage, uint32_t& phase) {
  using S = Layer<L>;
#pragma unroll 1
  for (int c = 0; c < S::nchunk; ++c) {
    mbar_wait(&empty[stage], phase ^ 1u);
    mbar_arrive_expect_tx(&full[stage], S::chunk_bytes);
    bulk_copy(stages + stage * STAGE_BYTES, src, S::chunk_bytes, &full[stage]);
    src += S::chunk_bytes;
    if (++stage == NSTAGE) {
      stage = 0;
      phase ^= 1u;
    }
  }
}

// the chain writes the gradient operands
template <int O>
__device__ __forceinline__ uint32_t* tile_dst(bf16* ops, int npad, int base, int warp, int lane) {
  static_assert(gfpp::listed(O, gfpp::CHAIN_OPERANDS), "the chain writes the gradient operands");
  return gfpp::operand_dst<O>(ops, npad, base, warp, lane);
}

// The next product's A fragments from a gradient through ReLU: bf16(the
// accumulator where the forward's activation was on, else 0). mg, mh: the
// layer's mask words of this lane's rows g and g + 8; h[s][i] is column
// block j = 2 s + i / 2 of row g + 8 (i % 2), accumulator entries 4 j + 2 (i
// % 2) + e, features 8 j + 2 t + e, mask bits 2 j + e.
__device__ __forceinline__ void masked_fragments(const float (&d)[64], uint32_t mg, uint32_t mh,
                                                 uint32_t (&h)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 2 * s + (i >> 1), r = i & 1;
      const uint32_t m = r ? mh : mg;
      const float v0 = (m >> (2 * j)) & 1u ? d[4 * j + 2 * r] : 0.0f;
      const float v1 = (m >> (2 * j + 1)) & 1u ? d[4 * j + 2 * r + 1] : 0.0f;
      h[s][i] = pack_bf16(v0, v1);
    }
}

// the 16 column blocks of an accumulator, rounded, as core matrices 2 j + h
// of operand dst (feature block j, point half h)
__device__ __forceinline__ void store_accumulator(uint32_t* dst, const float (&d)[64], bool live_g, bool live_h) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    store_fragment(dst + 32 * (2 * j), pack_bf16(d[4 * j], d[4 * j + 1]), live_g);
    store_fragment(dst + 32 * (2 * j + 1), pack_bf16(d[4 * j + 2], d[4 * j + 3]), live_h);
  }
}

// g_proj[64 HALF + c] = bf16(g_pos_feat[64 HALF + c] cos_p - g_pos_feat[128
// + 64 HALF + c] sin_p) from position half HALF's accumulator (columns c
// and 64 + c), stored as feature groups 8 HALF .. 8 HALF + 7 of gproj (not
// stored where dst is null: a tile wholly past n). P holds pos_B's rows 0..2.
template <int HALF>
__device__ __forceinline__ void position_gradient(uint32_t* dst, const float (&d)[64], const float (&xg)[3],
                                                  const float (&xh)[3], const float* P, int t, bool live_g,
                                                  bool live_h) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float* x = r ? xh : xg;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int f = 64 * HALF + 8 * j + 2 * t + e;
        const float proj = fmaf(x[2], P[256 + f], fmaf(x[1], P[128 + f], x[0] * P[f]));
        // the sin half's product rounded on its own, then one fused multiply-add
        const float sin_half = __fmul_rn(d[4 * j + 2 * r + e], fast_cos(proj));
        v[e] = __fmaf_rn(-d[4 * (j + 8) + 2 * r + e], fast_sin(proj), sin_half);
      }
      if (dst != nullptr) store_fragment(dst + 32 * (2 * (8 * HALF + j) + r), pack_bf16(v[0], v[1]), r ? live_h : live_g);
    }
}

enum ReluLayer { RELU_A1, RELU_A2, RELU_S1, RELU_S2, RELU_C1 };

__global__ void __launch_bounds__(NTHREAD, 1) fused_field_bwd_kernel(
    const float* __restrict__ xyz,             // [n, 3]
    const float* __restrict__ sigma,           // [n]     the forward's outputs
    const float* __restrict__ rgb,             // [n, 3]
    const float* __restrict__ amb,             // [n, 3]
    const unsigned char* __restrict__ gate,    // [n]     1 where the sigma logit is in (-15, 15)
    const uint32_t* __restrict__ relu,         // [RELU_LAYERS, npad, RELU_WORDS] ReLU masks
    int n,
    const float* __restrict__ g_sigma,         // [n]
    const float* __restrict__ g_rgb,           // [n, 3]
    const float* __restrict__ g_amb,           // [n, 3]
    const unsigned char* __restrict__ packed,  // the weight stream (SPEC)
    const float* __restrict__ pos_B,           // [8, 128] f32, rows 0..2 live
    const float* __restrict__ amb_B,           // [128, 64] f32, rows 0..2 live
    bf16* __restrict__ ops,                    // the weight-gradient operands (CHAIN_OPERANDS' rows)
    int npad) {                                // points each operand holds: n rounded up to TM
  extern __shared__ __align__(1024) unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem + OFF_PARAM);  // pos_B rows 0..2 | amb_B rows 0..2 | bf16(amb_B)
  float* AB = P + 384;
  float* ABR = AB + 192;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + NSTAGE;

  for (int i = threadIdx.x; i < PARAM_FLOATS; i += NTHREAD)
    P[i] = i < 384 ? pos_B[i] : i < 576 ? amb_B[i - 384] : gfpp::bf16_round(amb_B[i - 576]);
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NCONS);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int nsuper = (n + NCONS * TM - 1) / (NCONS * TM);
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    // ---- producer: one thread streams the weights, step after step ----
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int st = blockIdx.x; st < nsuper; st += gridDim.x) {
        const unsigned char* src = packed;
        produce<L_COL_W2>(src, smem, full, empty, stage, phase);
        produce<L_COL_W1>(src, smem, full, empty, stage, phase);
        produce<L_SIG_W3>(src, smem, full, empty, stage, phase);
        produce<L_SIG_W2>(src, smem, full, empty, stage, phase);
        produce<L_SIG_W1A>(src, smem, full, empty, stage, phase);
        produce<L_AMB_W3>(src, smem, full, empty, stage, phase);
        produce<L_AMB_W2>(src, smem, full, empty, stage, phase);
        produce<L_POS_LO>(src, smem, full, empty, stage, phase);
        produce<L_POS_HI>(src, smem, full, empty, stage, phase);
      }
    }
    return;
  }

  // ---- consumers: one 64-point tile each per step ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int quad = lane & ~3;
  Ring ring{full, empty, smem_addr(smem), 0, 0, 0u};

  for (int st = blockIdx.x; st < nsuper; st += gridDim.x) {
    const int base = (st * NCONS + cw) * TM;
    const int row_g = base + 16 * warp + g, row_h = row_g + 8;  // this thread's two rows
    const bool stores = base < n, live_g = row_g < n, live_h = row_h < n;
    uint32_t mg[gfpp::RELU_LAYERS], mh[gfpp::RELU_LAYERS];  // this lane's mask words
#pragma unroll
    for (int l = 0; l < gfpp::RELU_LAYERS; ++l) {
      const uint32_t* m = relu + static_cast<size_t>(l) * npad * gfpp::RELU_WORDS + t;
      mg[l] = live_g ? m[static_cast<size_t>(row_g) * gfpp::RELU_WORDS] : 0u;
      mh[l] = live_h ? m[static_cast<size_t>(row_h) * gfpp::RELU_WORDS] : 0u;
    }
    float acc[64];
    uint32_t h[8][4];

    // ---- colour MLP ----
    // g_rgb_logit = bf16(g_rgb * rgb * (1 - rgb)) as the A fragment of one
    // k16 step: lane t holds columns 2 t, 2 t + 1 (live for t < 2, column < 3)
    uint32_t f16[4] = {0u, 0u, 0u, 0u};
    if (t < 2) {
      float v[2][2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = r ? row_h : row_g, c = 2 * t + e;
          v[r][e] = 0.0f;
          if (c < 3 && row < n) {
            const float cc = rgb[3 * row + c];
            v[r][e] = g_rgb[3 * row + c] * cc * (1.0f - cc);
          }
        }
      f16[0] = pack_bf16(v[0][0], v[0][1]);
      f16[1] = pack_bf16(v[1][0], v[1][1]);
    }
    layer<L_COL_W2>(ring, [&](int, uint32_t b) { wgmma_m64n128k16_rs(acc, f16, desc(b), 0); });
    if (stores) {
      uint32_t* dst = tile_dst<gfpp::OP_GRGB>(ops, npad, base, warp, lane);
      store_fragment(dst, f16[0], live_g);
      store_fragment(dst + 32, f16[1], live_h);
    }
    fence_regs(acc);
    masked_fragments(acc, mg[RELU_C1], mh[RELU_C1], h);  // g_c1
    layer<L_COL_W1>(ring, [&](int k, uint32_t b) { wgmma_m64n128k16_rs(acc, h[k], desc(b), k > 0); });
    if (stores) {
      store_fragments<0, 4>(tile_dst<gfpp::OP_GC1A>(ops, npad, base, warp, lane), h, live_g, live_h);
      store_fragments<4, 8>(tile_dst<gfpp::OP_GC1B>(ops, npad, base, warp, lane), h, live_g, live_h);
    }
    fence_regs(acc);

    // ---- sigma MLP ----
    // g_sig_out = bf16([g_sigma * sigma (gated) | g_geo | 0]), 144 columns
    // (9 k16 steps). Column 8 J + 2 t is g_geo's column 8 J + 2 t - 1: lane
    // t - 1's, or for t = 0 lane 3's of block J - 1 (column 0: the sigma
    // gradient); column 8 J + 2 t + 1 is this lane's g_geo column 8 J + 2 t.
    uint32_t f9[9][4];
    {
      float sig_g = 0.0f, sig_h = 0.0f;  // lane t = 0: the gated sigma gradient of its rows
      if (t == 0) {
        if (live_g && gate[row_g]) sig_g = g_sigma[row_g] * sigma[row_g];
        if (live_h && gate[row_h]) sig_h = g_sigma[row_h] * sigma[row_h];
      }
      float cg = sig_g, ch = sig_h;  // what lane t = 0 takes for column 8 J
      const int left = quad | ((t + 3) & 3);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float pg = __shfl_sync(0xffffffffu, acc[4 * j + 1], left);
        const float ph = __shfl_sync(0xffffffffu, acc[4 * j + 3], left);
        f9[j >> 1][2 * (j & 1)] = pack_bf16(t ? pg : cg, acc[4 * j]);
        f9[j >> 1][2 * (j & 1) + 1] = pack_bf16(t ? ph : ch, acc[4 * j + 2]);
        cg = pg;
        ch = ph;
      }
      f9[8][0] = t == 0 ? pack_bf16(cg, 0.0f) : 0u;  // column 128: g_geo's 127
      f9[8][1] = t == 0 ? pack_bf16(ch, 0.0f) : 0u;
      f9[8][2] = f9[8][3] = 0u;
      if (stores) {  // [g_geo | g_sigma_logit | 0 x 7]; g_sigma_logit is lane t = 0's column-128 low half
        uint32_t* dst = tile_dst<gfpp::OP_GSIG>(ops, npad, base, warp, lane);
        store_accumulator(dst, acc, live_g, live_h);
        store_fragment(dst + 32 * 32, pack_bf16(sig_g, 0.0f), live_g);
        store_fragment(dst + 32 * 33, pack_bf16(sig_h, 0.0f), live_h);
      }
    }
    layer<L_SIG_W3>(ring, [&](int k, uint32_t b) { wgmma_m64n128k16_rs(acc, f9[k], desc(b), k > 0); });
    fence_regs(acc);
    masked_fragments(acc, mg[RELU_S2], mh[RELU_S2], h);  // g_s2
    layer<L_SIG_W2>(ring, [&](int k, uint32_t b) { wgmma_m64n128k16_rs(acc, h[k], desc(b), k > 0); });
    if (stores) store_fragments<0, 8>(tile_dst<gfpp::OP_GS2>(ops, npad, base, warp, lane), h, live_g, live_h);
    fence_regs(acc);
    uint32_t hs1[8][4];  // g_s1, to the position products
    masked_fragments(acc, mg[RELU_S1], mh[RELU_S1], hs1);
    layer<L_SIG_W1A>(ring, [&](int k, uint32_t b) { wgmma_m64n128k16_rs(acc, hs1[k], desc(b), k > 0); });
    if (stores) store_fragments<0, 8>(tile_dst<gfpp::OP_GS1>(ops, npad, base, warp, lane), hs1, live_g, live_h);
    fence_regs(acc);  // g_amb_feat

    // ---- ambient Fourier features and tanh ----
    // g_aproj[f] = bf16(g_amb_feat[f] cos(aproj[f]) - g_amb_feat[64 + f]
    // sin(aproj[f])): columns f and 64 + f are entries 4 j + . and 4 (j + 8) + .
    float ag[3], ah[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      ag[i] = live_g ? amb[3 * row_g + i] : 0.0f;
      ah[i] = live_h ? amb[3 * row_h + i] : 0.0f;
    }
    uint32_t q[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * s + (i >> 1), r = i & 1;
        const float* a = r ? ah : ag;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = 8 * j + 2 * t + e;
          const float proj = fmaf(a[2], AB[128 + f], fmaf(a[1], AB[64 + f], a[0] * AB[f]));
          v[e] = acc[4 * j + 2 * r + e] * fast_cos(proj) - acc[4 * (j + 8) + 2 * r + e] * fast_sin(proj);
        }
        q[s][i] = pack_bf16(v[0], v[1]);
      }
    if (stores) store_fragments<0, 4>(tile_dst<gfpp::OP_GAPROJ>(ops, npad, base, warp, lane), q, live_g, live_h);
    // g_amb_logit = bf16((bf16(g_aproj) . bf16(amb_B)^T + g_amb) * (1 - amb_pos^2)):
    // lane t < 3 sums column t of both its rows over the quad's fragments, f
    // = 0..63 ascending (lane 3 repeats column 2's sum and drops it)
    const int jc = t < 3 ? t : 2;
    float sg = 0.0f, sh = 0.0f;
#pragma unroll
    for (int jb = 0; jb < 8; ++jb)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t wg_ = __shfl_sync(0xffffffffu, q[jb >> 1][2 * (jb & 1)], quad | u);
        const uint32_t wh_ = __shfl_sync(0xffffffffu, q[jb >> 1][2 * (jb & 1) + 1], quad | u);
        const float* b = ABR + 64 * jc + 8 * jb + 2 * u;
        sg = fmaf(__uint_as_float(wg_ << 16), b[0], sg);
        sg = fmaf(__uint_as_float(wg_ & 0xFFFF0000u), b[1], sg);
        sh = fmaf(__uint_as_float(wh_ << 16), b[0], sh);
        sh = fmaf(__uint_as_float(wh_ & 0xFFFF0000u), b[1], sh);
      }
    uint32_t f3[4] = {0u, 0u, 0u, 0u};
    {
      const float a_g = t == 0 ? ag[0] : t == 1 ? ag[1] : ag[2];
      const float a_h = t == 0 ? ah[0] : t == 1 ? ah[1] : ah[2];
      const float gag = live_g ? g_amb[3 * row_g + jc] : 0.0f, gah = live_h ? g_amb[3 * row_h + jc] : 0.0f;
      const float vg = t < 3 ? (sg + gag) * (1.0f - a_g * a_g) : 0.0f;
      const float vh = t < 3 ? (sh + gah) * (1.0f - a_h * a_h) : 0.0f;
      // the A fragment: lane 0 holds columns 0, 1, lane 1 column 2
      const float ng = __shfl_sync(0xffffffffu, vg, quad | ((t + 1) & 3));
      const float nh = __shfl_sync(0xffffffffu, vh, quad | ((t + 1) & 3));
      if (t == 0) {
        f3[0] = pack_bf16(vg, ng);
        f3[1] = pack_bf16(vh, nh);
      } else if (t == 1) {
        f3[0] = pack_bf16(ng, 0.0f);
        f3[1] = pack_bf16(nh, 0.0f);
      }
    }

    // ---- ambient MLP ----
    layer<L_AMB_W3>(ring, [&](int, uint32_t b) { wgmma_m64n128k16_rs(acc, f3, desc(b), 0); });
    if (stores) {
      uint32_t* dst = tile_dst<gfpp::OP_GAMB>(ops, npad, base, warp, lane);
      store_fragment(dst, f3[0], live_g);
      store_fragment(dst + 32, f3[1], live_h);
    }
    fence_regs(acc);
    masked_fragments(acc, mg[RELU_A2], mh[RELU_A2], h);  // g_a2
    layer<L_AMB_W2>(ring, [&](int k, uint32_t b) { wgmma_m64n128k16_rs(acc, h[k], desc(b), k > 0); });
    if (stores) store_fragments<0, 8>(tile_dst<gfpp::OP_GA2>(ops, npad, base, warp, lane), h, live_g, live_h);
    fence_regs(acc);
    masked_fragments(acc, mg[RELU_A1], mh[RELU_A1], h);  // g_a1

    // ---- position Fourier features ----
    // g_pos_feat = g_s1 . sig_w1p^T + g_a1 . amb_w1p^T in two halves; half
    // b's accumulator holds features 64 b + c (sin) in column c < 64 and
    // 128 + 64 b + c (cos) in column 64 + c, so g_proj[64 b + c] =
    // g_sin . cos_p - g_cos . sin_p stays in the thread
    float xg[3], xh[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      xg[i] = live_g ? xyz[3 * row_g + i] : 0.0f;
      xh[i] = live_h ? xyz[3 * row_h + i] : 0.0f;
    }
    uint32_t* gproj = stores ? tile_dst<gfpp::OP_GPROJ>(ops, npad, base, warp, lane) : nullptr;
    auto pos_products = [&](int k, uint32_t b) {
      if (k < 8)
        wgmma_m64n128k16_rs(acc, hs1[k < 8 ? k : 0], desc(b), k > 0);
      else
        wgmma_m64n128k16_rs(acc, h[k >= 8 ? k - 8 : 0], desc(b), 1);
    };
    layer<L_POS_LO>(ring, pos_products);
    fence_regs(acc);
    position_gradient<0>(gproj, acc, xg, xh, P, t, live_g, live_h);
    layer<L_POS_HI>(ring, pos_products);
    if (stores) store_fragments<0, 8>(tile_dst<gfpp::OP_GA1>(ops, npad, base, warp, lane), h, live_g, live_h);
    fence_regs(acc);
    position_gradient<1>(gproj, acc, xg, xh, P, t, live_g, live_h);
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

// Launches the tile chain on `stream` (one persistent block an SM) and
// returns cudaGetLastError() (0 on success). sigma, rgb, amb, gate and relu
// are the forward's train mode's; `packed` is pack_chain_weights' stream
// (16-byte aligned, SPEC's layout); `ops` is the operand buffer the train
// mode wrote (npad * OPERAND_ROWS bf16, npad = n rounded up to the 64-point
// tile), which receives CHAIN_OPERANDS' rows.
int gfpp_fused_field_backward(const void* xyz, const void* sigma, const void* rgb, const void* amb,
                              const void* gate, const void* relu, int n, const void* g_sigma,
                              const void* g_rgb, const void* g_amb, const void* packed, const void* pos_B,
                              const void* amb_B, void* ops, int npad, void* stream) {
  if (n <= 0 || npad != (n + TM - 1) / TM * TM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(fused_field_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // setmaxnreg's register moves assume the launch bound's full allocation
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fused_field_bwd_kernel)) != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != LAUNCH_REGS) return static_cast<int>(cudaErrorInvalidConfiguration);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int nsuper = (n + NCONS * TM - 1) / (NCONS * TM);
  const unsigned grid = static_cast<unsigned>(nsuper < sms ? nsuper : sms);
  fused_field_bwd_kernel<<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(sigma), static_cast<const float*>(rgb),
      static_cast<const float*>(amb), static_cast<const unsigned char*>(gate), static_cast<const uint32_t*>(relu),
      n, static_cast<const float*>(g_sigma), static_cast<const float*>(g_rgb), static_cast<const float*>(g_amb),
      static_cast<const unsigned char*>(packed), static_cast<const float*>(pos_B),
      static_cast<const float*>(amb_B), static_cast<bf16*>(ops), npad);
  return static_cast<int>(cudaGetLastError());
}

// The weight stream's layout as the kernel reads it: row l of `spec` gets
// SPEC[l] (k16 steps, N, k16 steps per chunk). Returns the number of
// products.
int gfpp_fused_field_bwd_layout(int* spec, int rows) {
  for (int l = 0; l < NLAYER && l < rows; ++l)
    for (int j = 0; j < 3; ++j) spec[3 * l + j] = SPEC[l][j];
  return NLAYER;
}

// How the chain is built: points a consumer tile, consumer warpgroups a
// block (one block an SM), weight-ring stages, dynamic shared memory a
// block in bytes, registers a thread at launch and a consumer's after
// setmaxnreg.
int gfpp_fused_field_bwd_config(int* tile, int* consumers, int* stages, int* smem_bytes, int* launch_regs,
                                int* consumer_regs) {
  *tile = TM;
  *consumers = NCONS;
  *stages = NSTAGE;
  *smem_bytes = SMEM_BYTES;
  *launch_regs = LAUNCH_REGS;
  *consumer_regs = CONSUMER_REGS;
  return 0;
}

const char* gfpp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
