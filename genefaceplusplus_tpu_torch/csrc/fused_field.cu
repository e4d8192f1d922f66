// Fused RAD-NeRF head-field forward for Hopper (sm_90a).
//
// Replaces the TPU kernel genefaceplusplus_tpu/ops/pallas/fused_field.py:_kernel
// (launched by fused_field_eval, pallas_call at :252). Per point it computes
//   xyz.B (f32) -> fast sin/cos -> ambient MLP x3 (cond folded into a bias row)
//   -> fast tanh -> ambient Fourier -> sigma MLP x3 -> exp(clip(., +-15)), geo
//   -> SH16(dirs) -> colour MLP x2 (ind code folded into a bias row) -> sigmoid
// at the flagship width (pos 128, amb 64, hidden 128, geo 128, cond 64).
//
// What bounds it on an H100: arithmetic. A point costs 150,400 multiply-adds
// at their live widths in eight dependent products (K <= 384, N <= 129;
// the kernel issues 152,576, padding N to 8 or 136) against 52 bytes of
// device traffic (xyz and dirs in, sigma, rgb and amb out): 0.797 ms of
// dense bf16 tensor-core work for a 512^2 x 10-sample frame. The weights the products
// read (298 KB) exceed a block's shared memory, so they stream from L2.
//
// What the design does about it:
// - Every product is a warpgroup product (wgmma m64nNk16, bf16 in, f32
//   sums), one consumer warpgroup per 64-point tile. The A operand of each
//   hidden layer comes from registers: a layer's f32 accumulator gets bias,
//   ReLU and bf16 rounding in registers and is the next layer's A fragment
//   (sm90.cuh), with no shared-memory round trip and no block barrier.
//   amb_feat and SH16 are computed straight into A fragments.
// - Persistent: one block per SM walks steps of NCONS x 64 points, NCONS =
//   3 consumer warpgroups. One producer thread streams the weights, packed
//   on the host in the wgmma layout (ops/fused_field.py,
//   pack_field_weights), chunk by chunk with bulk copies into a ring of
//   NSTAGE shared-memory stages (mbarriers full/empty); every consumer reads
//   each staged chunk, so a weight byte fetched from L2 serves 192 points.
// - The position features (256 sin/cos a point, the largest CUDA-core job)
//   do not wait in the consumers' chain: the producer warpgroup's other
//   three warps compute them ahead into a ring of NPOS pos_feat tiles in
//   shared memory (mbarriers pos_full/pos_empty), which the two layers that
//   read pos_feat take as descriptor operands. The consumers run
//   unsynchronised but for the rings, so one warpgroup's CUDA-core work
//   (epilogues) overlaps another's products; amb_feat and SH16 are computed
//   while the warpgroup's own products that do not need them are in
//   flight; setmaxnreg moves the producers' registers to the consumers.
// Measured on an H100 (PERF.md): about half of the bound; what is left is
// mostly the position features, which three warps only just keep ahead of.
//
// Two instantiations (template TRAIN). Serving (TRAIN = false) writes the
// three outputs only. The train mode also writes what the backward needs,
// so that the backward's chain (fused_field_bwd.cu) does not recompute the
// forward:
// - The activation half of the weight-gradient operands
//   (fused_field_common.cuh, TRAIN_OPERANDS: pos_feat, amb_feat, the five
//   hidden layers, [geo | SH], bf16 amb_pos and xyz; 1,184 bf16 a point) in
//   the operand buffer's K-major layout, whose 64-point tiles are the
//   consumers' tiles. No staging tile: shared memory is full (the block
//   uses 219,520 of 232,448 bytes). A bf16 pair of an A fragment (or of
//   hidden-layer registers) of one 8-feature block is an m8n8 matrix, rows
//   8 points, columns 2 features a lane; movmatrix.trans turns it into 2
//   points of one feature a lane, and the warp's 32 4-byte stores fill one
//   contiguous 128-byte core matrix of the operand (8 features x 8 points),
//   since a warp's 16 rows are exactly one k16 step of the operand.
//   pos_feat, which sits in shared memory in the A layout, goes out through
//   ldmatrix.trans the same way, before its ring slot is released.
// - The ReLU masks of the five hidden layers (80 bytes a point; the chain
//   reads these instead of re-reading 1,280 bytes of activations), each
//   lane one 32-bit word of its row quad (fused_field_common.cuh,
//   relu_word): a bit is set where the bf16 activation is non-zero, which
//   is where the f32 pre-activation is positive but below 2^-134.
// - The sigma gate: one byte a point, 1 where the logit is in (-15, 15).
// Rows past n are written as zeros; a consumer tile that lies wholly past
// n (the last block step's) writes nothing. A layer's stores go out once
// the next products, which read the same registers, have completed and
// before the registers are overwritten. Issued before those products, the
// consumers spilled (ptxas batched the 32 movmatrix of a layer ahead of
// their stores while the registers stayed live as the products' A
// operand); so did xyz loaded for its operand at the top of the tile
// (hence pinned loads at its end). ptxas -v must report no spill for
// either instantiation (chip_smoke.py's build phase checks).
// Rounding points are the Pallas kernel's: bf16 at pos_feat, each post-ReLU
// hidden layer, amb_feat, geo and SH16; the Fourier phases as the f32 FMA
// chain; rintf inside fast_sin; expf(clip(+-15)) for sigma; sigmoid by true
// division; f32 sums in every product (never TF32), k in ascending 16-steps.
// The padding of the TPU layout is skipped (N = 8 for the 3-wide outputs,
// 136 for sigma|geo) and the ragged last tile is masked here.
//
// Build (no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_field.so fused_field.cu

#include "fused_field_common.cuh"
#include "sm90.cuh"

using gfpp::bf16;
using gfpp::fast_cos;
using gfpp::fast_sin;
using gfpp::fast_tanh;
using gfpp::store_fragment;
using namespace gfpp::sm90;

namespace {

constexpr int TM = 64;     // points per consumer warpgroup
constexpr int NCONS = 3;   // consumer warpgroups sharing each weight chunk
constexpr int NTHREAD = 128 * (1 + NCONS);  // warpgroup 0 produces
constexpr int NSTAGE = 3;  // weight ring depth
constexpr int NPOS = 5;    // pos_feat ring depth
// registers: each thread starts with the launch bound's share (128 a thread
// at 512 threads); the producers give theirs down to 56, the consumers take
// them (152)
constexpr int LAUNCH_REGS = 65536 / NTHREAD / 8 * 8, PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = (65536 - 128 * PRODUCER_REGS) / (128 * NCONS) / 8 * 8;
static_assert(CONSUMER_REGS >= LAUNCH_REGS && CONSUMER_REGS <= 256, "register split");

// The packed weight stream, in the order the products read it: each layer's
// B operand (N rows x K, K-major, sm90.cuh layout), cut into chunks of whole
// k16 steps. {k16 steps, N, k16 steps per chunk}; ops/fused_field.py's
// FWD_LAYERS is the same table (checked when the library loads).
constexpr int SPEC[8][3] = {
    {16, 128, 4},  // amb_w1 rows 0..255 (pos_feat)
    {8, 128, 4},   // amb_w2
    {8, 8, 8},     // amb_w3 columns 0..2, zero-padded to 8
    {24, 128, 4},  // sig_w1: pos_feat 256 | amb_feat 128
    {8, 128, 4},   // sig_w2
    {8, 136, 4},   // sig_w3 columns 1..128 (geo), then column 0 (sigma) + 7 zero columns
    {9, 128, 3},   // col_w1 rows 0..143: SH 16 | geo 128
    {8, 8, 8},     // col_w2 columns 0..2, zero-padded to 8
};

template <int L>
struct Layer {
  static constexpr int ksteps = SPEC[L][0], n = SPEC[L][1], chunk = SPEC[L][2];
  static constexpr int nchunk = ksteps / chunk;
  static constexpr int kstep_bytes = n * 32, chunk_bytes = chunk * kstep_bytes;
  static_assert(ksteps % chunk == 0, "whole chunks");
};

constexpr int STAGE_BYTES = Layer<5>::chunk_bytes;  // the largest chunk, 17,408 bytes
constexpr int POS_BYTES = TM * 256 * 2;             // one tile's pos_feat (16 k16 steps of A)
constexpr int PARAM_FLOATS = 3 * 128 + 3 * 64 + 128 + 128;  // pos_B, amb_B, amb_bias, col_bias
constexpr int OFF_POS = NSTAGE * STAGE_BYTES;
constexpr int OFF_PARAM = OFF_POS + NPOS * POS_BYTES;
constexpr int OFF_BAR = OFF_PARAM + PARAM_FLOATS * 4;
constexpr int SMEM_BYTES = OFF_BAR + 2 * (NSTAGE + NPOS) * 8;
static_assert(STAGE_BYTES % 128 == 0 && POS_BYTES % 128 == 0 && OFF_BAR % 8 == 0, "alignment");
static_assert(SMEM_BYTES <= 232448, "shared memory");

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

// One layer's product: for each chunk, wait for it, start its k steps
// (products(k, B descriptor address)), run after(c) (CUDA-core work that
// overlaps the products in flight), and release the previous chunk's stage
// once its products have completed. Returns with every product done.
template <int L, class Products, class After>
__device__ __forceinline__ void layer(Ring& r, Products&& products, After&& after) {
  using S = Layer<L>;
#pragma unroll
  for (int c = 0; c < S::nchunk; ++c) {
    mbar_wait(&r.full[r.stage], r.phase);
    const uint32_t b = r.base + r.stage * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < S::chunk; ++kk) products(c * S::chunk + kk, b + kk * S::kstep_bytes);
    wgmma_commit();
    after(c);
    if (c > 0) {
      wgmma_wait<1>();
      r.release(r.prev);
    }
    r.advance();
  }
  wgmma_wait<0>();
  r.release(r.prev);
}

template <int L, class Products>
__device__ __forceinline__ void layer(Ring& r, Products&& products) {
  layer<L>(r, products, [](int) {});
}

// The producer's side of one layer: each chunk into the next free stage.
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

// pos_feat of the 64-point tile at `base` into `buf` (A operand, 16 k16
// steps: sin at k = f, cos at k = 128 + f, bf16). The tile is 32 units of
// (8-feature chunk, 32 rows); feature warp fw of 3 takes units fw, fw + 3,
// ... (11, 11 and 10 units), its lane one row of each.
__device__ __forceinline__ void position_features(unsigned char* buf, const float* __restrict__ xyz, int n,
                                                  int base, const float* P, int fw, int lane) {
  float x[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = base + lane + 32 * h;
#pragma unroll
    for (int j = 0; j < 3; ++j) x[h][j] = p < n ? xyz[3 * p + j] : 0.0f;
  }
  for (int u = fw; u < 32; u += 3) {
    const int c = u >> 1, h = u & 1, r = lane + 32 * h;
    const float x0 = h ? x[1][0] : x[0][0], x1 = h ? x[1][1] : x[0][1], x2 = h ? x[1][2] : x[0][2];
    float b[3][8];  // rows 0..2 of pos_B, features 8c .. 8c + 7
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 lo = *reinterpret_cast<const float4*>(P + 128 * i + 8 * c);
      const float4 hi = *reinterpret_cast<const float4*>(P + 128 * i + 8 * c + 4);
      b[i][0] = lo.x, b[i][1] = lo.y, b[i][2] = lo.z, b[i][3] = lo.w;
      b[i][4] = hi.x, b[i][5] = hi.y, b[i][6] = hi.z, b[i][7] = hi.w;
    }
    uint32_t sn[4], cs[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p0 = fmaf(x2, b[2][2 * e], fmaf(x1, b[1][2 * e], x0 * b[0][2 * e]));
      const float p1 = fmaf(x2, b[2][2 * e + 1], fmaf(x1, b[1][2 * e + 1], x0 * b[0][2 * e + 1]));
      sn[e] = pack_bf16(fast_sin(p0), fast_sin(p1));
      cs[e] = pack_bf16(fast_cos(p0), fast_cos(p1));
    }
    const int off = (c >> 1) * 2048 + ((r >> 3) * 2 + (c & 1)) * 128 + (r & 7) * 16;
    *reinterpret_cast<uint4*>(buf + off) = make_uint4(sn[0], sn[1], sn[2], sn[3]);
    *reinterpret_cast<uint4*>(buf + 8 * 2048 + off) = make_uint4(cs[0], cs[1], cs[2], cs[3]);
  }
}

// column of accumulator register i (m64nN layout), for lane quad position t
__device__ __forceinline__ int acc_col(int i, int t) { return 8 * (i >> 2) + 2 * t + (i & 1); }

// next layer's A fragments: bf16(relu(acc + bias)), bias optional
template <bool BIAS, bool RELU>
__device__ __forceinline__ void to_fragments(const float (&d)[64], const float* bias, uint32_t (&h)[8][4], int t) {
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 8 * s + 2 * i;
      float v0 = d[j], v1 = d[j + 1];
      if (BIAS) {
        const int col = acc_col(j, t);
        v0 += bias[col];
        v1 += bias[col + 1];
      }
      if (RELU) {
        v0 = fmaxf(v0, 0.0f);
        v1 = fmaxf(v1, 0.0f);
      }
      h[s][i] = pack_bf16(v0, v1);
    }
}

// The ReLU mask words of this lane's rows g (mg) and g + 8 (mh) from a
// layer's bf16 activations (A fragments, after ReLU): column 8 j + 2 t + e
// is bit 2 j + e (relu_word, relu_bit). A bf16 is non-zero exactly where
// the f32 pre-activation is positive, but below 2^-134.
__device__ __forceinline__ void relu_masks(const uint32_t (&h)[8][4], uint32_t& mg, uint32_t& mh) {
  mg = 0u;
  mh = 0u;
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int bit = 2 * (2 * s + (i >> 1));
      const uint32_t m = ((h[s][i] & 0x7FFFu) ? 1u << bit : 0u) | ((h[s][i] & 0x7FFF0000u) ? 2u << bit : 0u);
      if (i & 1)
        mh |= m;
      else
        mg |= m;
    }
}

// ---- the train mode's stores (fused_field_common.cuh: operand_dst,
// store_fragment, store_fragments) ----
template <int O>
__device__ __forceinline__ uint32_t* tile_dst(bf16* ops, int npad, int base, int warp, int lane) {
  static_assert(gfpp::listed(O, gfpp::TRAIN_OPERANDS), "the forward's train mode writes the activation operands");
  return gfpp::operand_dst<O>(ops, npad, base, warp, lane);
}

// a 128-feature layer held as A fragments as operand O
template <int O>
__device__ __forceinline__ void store_layer(bf16* ops, int npad, int base, int warp, int lane,
                                            const uint32_t (&h)[8][4], bool live_g, bool live_h) {
  gfpp::store_fragments<0, 8>(tile_dst<O>(ops, npad, base, warp, lane), h, live_g, live_h);
}

// an 8-row operand whose features 0..2 are a 3-wide value (apos, xyzb): the
// fragments of rows g (fg) and g + 8 (fh), this lane's columns 2 t, 2 t + 1
// (lane t = 0: features 0, 1; t = 1: feature 2 and a zero; t > 1: zeros)
template <int O>
__device__ __forceinline__ void store_three(bf16* ops, int npad, int base, int warp, int lane, uint32_t fg,
                                            uint32_t fh, bool live_g, bool live_h) {
  uint32_t* dst = tile_dst<O>(ops, npad, base, warp, lane);
  store_fragment(dst, fg, live_g);
  store_fragment(dst + 32, fh, live_h);
}

// a load the compiler keeps where it is written (not hoisted to the top of
// the tile, where its value would stay live across every product)
__device__ __forceinline__ float pinned_load(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// the tile's pos_feat (A layout in shared memory at `pos`) as operands x0..x3:
// this warp's 16 rows, all 256 features. ldmatrix.trans of matrices m =
// 0..3 at k16 step q: point group 2 warp + m / 2, feature group 2 q + m % 2;
// lane's register m then holds feature 16 q + 8 (m % 2) + g of points
// 16 warp + 8 (m / 2) + 2 t, + 1
template <int O>
__device__ __forceinline__ void store_pos_block(bf16* ops, int npad, int n, int base, int warp, int lane,
                                                uint32_t pos) {
  constexpr int b = O - gfpp::OP_X0;  // 64 features an operand: k16 steps 4 b .. 4 b + 3 of pos_feat
  static_assert(b >= 0 && b < 4 && gfpp::OP_X3 == gfpp::OP_X0 + 3, "x0..x3");
  uint32_t* dst = tile_dst<O>(ops, npad, base, warp, lane);
  const int p = base + 16 * warp + 2 * (lane & 3);  // this lane's first point of the first point half
#pragma unroll
  for (int q = 4 * b; q < 4 * b + 4; ++q) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, pos + q * 2048 + warp * 512 + lane * 16);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int pm = p + 8 * (m >> 1);
      const uint32_t v = pm >= n ? 0u : pm + 1 >= n ? (r[m] & 0xFFFFu) : r[m];
      dst[32 * (4 * (q & 3) + 2 * (m & 1) + (m >> 1))] = v;  // core (feature group in the operand, point half)
    }
  }
}

__device__ __forceinline__ void store_pos_feat(bf16* ops, int npad, int n, int base, int warp, int lane,
                                               uint32_t pos) {
  store_pos_block<gfpp::OP_X0>(ops, npad, n, base, warp, lane, pos);
  store_pos_block<gfpp::OP_X1>(ops, npad, n, base, warp, lane, pos);
  store_pos_block<gfpp::OP_X2>(ops, npad, n, base, warp, lane, pos);
  store_pos_block<gfpp::OP_X3>(ops, npad, n, base, warp, lane, pos);
}

// layer l's ReLU mask words of this lane's rows (zero past n)
__device__ __forceinline__ void store_mask(uint32_t* relu, int npad, int l, int row_g, int row_h, int n, int t,
                                           uint32_t mg, uint32_t mh) {
  uint32_t* dst = relu + (static_cast<size_t>(l) * npad + row_g) * gfpp::RELU_WORDS + t;
  dst[0] = row_g < n ? mg : 0u;
  dst[8 * gfpp::RELU_WORDS] = row_h < n ? mh : 0u;  // row_h = row_g + 8
}

template <bool TRAIN>
__global__ void __launch_bounds__(NTHREAD, 1) fused_field_kernel(
    const float* __restrict__ xyz,             // [n, 3]
    const float* __restrict__ dirs,            // [n, 3]
    int n,
    const unsigned char* __restrict__ packed,  // the weight stream (SPEC)
    const float* __restrict__ pos_B,           // [8, 128] f32, rows 0..2 live (2 pi / bound folded in)
    const float* __restrict__ amb_B,           // [128, 64] f32, rows 0..2 live (2 pi folded in)
    const float* __restrict__ amb_bias,        // [128] bf16(cond) . amb_w1[256:], as f32
    const float* __restrict__ col_bias,        // [128] bf16(ind) . col_w1[144:160], as f32
    float* __restrict__ sigma_out,             // [n]
    float* __restrict__ rgb_out,               // [n, 3]
    float* __restrict__ amb_out,               // [n, 3]
    bf16* __restrict__ ops,                    // TRAIN: the operand buffer (TRAIN_OPERANDS' rows)
    int npad,                                  // TRAIN: points an operand holds, n rounded up to TM
    uint32_t* __restrict__ relu,               // TRAIN: [RELU_LAYERS, npad, RELU_WORDS] ReLU masks
    unsigned char* __restrict__ gate) {        // TRAIN: [n] 1 where the sigma logit is in (-15, 15)
  extern __shared__ __align__(1024) unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem + OFF_PARAM);  // pos_B rows 0..2 | amb_B rows 0..2 | biases
  float* AB = P + 384;
  float* BIAS_AMB = AB + 192;
  float* BIAS_COL = BIAS_AMB + 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);  // weight ring
  uint64_t* empty = full + NSTAGE;
  uint64_t* pos_full = empty + NSTAGE;  // pos_feat ring
  uint64_t* pos_empty = pos_full + NPOS;

  for (int i = threadIdx.x; i < PARAM_FLOATS; i += NTHREAD)
    P[i] = i < 384 ? pos_B[i] : i < 576 ? amb_B[i - 384] : i < 704 ? amb_bias[i - 576] : col_bias[i - 704];
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NCONS);  // one arrival per consumer warp
    }
    for (int b = 0; b < NPOS; ++b) {
      mbar_init(&pos_full[b], 3);   // one arrival per feature warp
      mbar_init(&pos_empty[b], 4);  // one per warp of the consumer that read it
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int nsuper = (n + NCONS * TM - 1) / (NCONS * TM);
  const int wg = threadIdx.x >> 7;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp > 0) {
      // ---- feature warps: pos_feat of each tile, in the consumers' order ----
      int j = 0;  // the block's tile count: step i, consumer cw -> NCONS i + cw
      for (int st = blockIdx.x; st < nsuper; st += gridDim.x)
        for (int cw = 0; cw < NCONS; ++cw, ++j) {
          const int pb = j % NPOS;
          mbar_wait(&pos_empty[pb], ((j / NPOS) & 1) ^ 1u);
          position_features(smem + OFF_POS + pb * POS_BYTES, xyz, n, (st * NCONS + cw) * TM, P, warp - 1, lane);
          fence_proxy_async();  // the writes, to the products that read them
          __syncwarp();
          if (lane == 0) mbar_arrive(&pos_full[pb]);
        }
    } else if (lane == 0) {
      // ---- weight producer: one thread streams the weights, step after step ----
      int stage = 0;
      uint32_t phase = 0;
      for (int st = blockIdx.x; st < nsuper; st += gridDim.x) {
        const unsigned char* src = packed;
        produce<0>(src, smem, full, empty, stage, phase);
        produce<1>(src, smem, full, empty, stage, phase);
        produce<2>(src, smem, full, empty, stage, phase);
        produce<3>(src, smem, full, empty, stage, phase);
        produce<4>(src, smem, full, empty, stage, phase);
        produce<5>(src, smem, full, empty, stage, phase);
        produce<6>(src, smem, full, empty, stage, phase);
        produce<7>(src, smem, full, empty, stage, phase);
      }
    }
  } else {
    // ---- consumers: one 64-point tile each per step ----
    setmaxnreg_inc<CONSUMER_REGS>();
    const int cw = wg - 1;
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    Ring ring{full, empty, smem_addr(smem), 0, 0, 0u};

    for (int st = blockIdx.x, j = cw; st < nsuper; st += gridDim.x, j += NCONS) {
      const int base = (st * NCONS + cw) * TM;
      const int row_g = base + 16 * warp + g, row_h = row_g + 8;  // this thread's two rows
      const int pb = j % NPOS;  // this tile's pos_feat
      const uint32_t pos_addr = smem_addr(smem + OFF_POS + pb * POS_BYTES);
      float dg[3] = {0.0f, 0.0f, 0.0f}, dh[3] = {0.0f, 0.0f, 0.0f};  // view dirs, for SH16
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (row_g < n) dg[i] = dirs[3 * row_g + i];
        if (row_h < n) dh[i] = dirs[3 * row_h + i];
      }
      // TRAIN: the tile is in the operand buffer (it starts before n); rows
      // of it past n are written as zeros
      const bool stores = TRAIN && base < n, live_g = row_g < n, live_h = row_h < n;
      uint32_t mg, mh;
      mbar_wait(&pos_full[pb], (j / NPOS) & 1);

      // 1. ambient MLP; the condition enters through amb_bias
      float acc[64];
      uint32_t h[8][4];
      layer<0>(ring, [&](int k, uint32_t b) {
        wgmma_m64n128k16_ss(acc, desc(pos_addr + k * 2048), desc(b), k > 0);
      });
      fence_regs(acc);
      to_fragments<true, true>(acc, BIAS_AMB, h, t);
      layer<1>(ring, [&](int k, uint32_t b) { wgmma_m64n128k16_rs(acc, h[k], desc(b), k > 0); });
      if (stores) {
        relu_masks(h, mg, mh);
        store_layer<gfpp::OP_A1>(ops, npad, base, warp, lane, h, live_g, live_h);
        store_mask(relu, npad, 0, row_g, row_h, n, t, mg, mh);
      }
      fence_regs(acc);
      to_fragments<false, true>(acc, nullptr, h, t);
      float a8[4];
      layer<2>(ring, [&](int k, uint32_t b) { wgmma_m64n8k16_rs(a8, h[k], desc(b), k > 0); });
      if (stores) {
        relu_masks(h, mg, mh);
        store_layer<gfpp::OP_A2>(ops, npad, base, warp, lane, h, live_g, live_h);
        store_mask(relu, npad, 1, row_g, row_h, n, t, mg, mh);
      }
      fence_regs(a8);

      // 2. ambient coordinate (f32): columns 0, 1 sit in lane t = 0, column
      // 2 in t = 1; each lane of the quad gets all three for both its rows
      {
        const float tg0 = fast_tanh(a8[0]), tg1 = fast_tanh(a8[1]);
        const float th0 = fast_tanh(a8[2]), th1 = fast_tanh(a8[3]);
        if (stores)  // bf16(amb_pos): lane t = 0 holds columns 0, 1, lane t = 1 column 2
          store_three<gfpp::OP_APOS>(ops, npad, base, warp, lane,
                                     t == 0 ? pack_bf16(tg0, tg1) : t == 1 ? pack_bf16(tg0, 0.0f) : 0u,
                                     t == 0 ? pack_bf16(th0, th1) : t == 1 ? pack_bf16(th0, 0.0f) : 0u, live_g, live_h);
        if (t == 0) {
          if (row_g < n) {
            amb_out[3 * row_g] = tg0;
            amb_out[3 * row_g + 1] = tg1;
          }
          if (row_h < n) {
            amb_out[3 * row_h] = th0;
            amb_out[3 * row_h + 1] = th1;
          }
        } else if (t == 1) {
          if (row_g < n) amb_out[3 * row_g + 2] = tg0;
          if (row_h < n) amb_out[3 * row_h + 2] = th0;
        }
        const int q = lane & ~3;
        const float ag[3] = {__shfl_sync(0xffffffffu, tg0, q), __shfl_sync(0xffffffffu, tg1, q),
                             __shfl_sync(0xffffffffu, tg0, q + 1)};
        const float ah[3] = {__shfl_sync(0xffffffffu, th0, q), __shfl_sync(0xffffffffu, th1, q),
                             __shfl_sync(0xffffffffu, th0, q + 1)};
        // 3. sigma MLP over [pos_feat | amb_feat]. amb_feat, as A fragments
        // (k steps 0..3 sin, 4..7 cos of the same phases), is computed a
        // quarter at a time while the pos_feat products (chunks 0..3) run.
        uint32_t af[8][4];
        layer<3>(ring, [&](int k, uint32_t b) {
          if (k < 16)
            wgmma_m64n128k16_ss(acc, desc(pos_addr + k * 2048), desc(b), k > 0);
          else
            wgmma_m64n128k16_rs(acc, af[k >= 16 ? k - 16 : 0], desc(b), 1);
        }, [&](int s) {
          if (s < 4) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float* a = (i & 1) ? ah : ag;
              const int f = 16 * s + 8 * (i >> 1) + 2 * t;
              const float p0 = fmaf(a[2], AB[128 + f], fmaf(a[1], AB[64 + f], a[0] * AB[f]));
              const float p1 = fmaf(a[2], AB[129 + f], fmaf(a[1], AB[65 + f], a[0] * AB[f + 1]));
              af[s][i] = pack_bf16(fast_sin(p0), fast_sin(p1));
              af[s + 4][i] = pack_bf16(fast_cos(p0), fast_cos(p1));
            }
          }
        });
        static_assert(Layer<3>::chunk == 4, "chunks 0..3 are the pos_feat k steps");
        if (stores) {  // amb_feat's products are done
          store_layer<gfpp::OP_XA>(ops, npad, base, warp, lane, af, live_g, live_h);
          store_pos_feat(ops, npad, n, base, warp, lane, pos_addr);
        }
      }
      if (lane == 0) mbar_arrive(&pos_empty[pb]);  // done with pos_feat
      fence_regs(acc);
      to_fragments<false, true>(acc, nullptr, h, t);
      layer<4>(ring, [&](int k, uint32_t b) { wgmma_m64n128k16_rs(acc, h[k], desc(b), k > 0); });
      if (stores) {
        relu_masks(h, mg, mh);
        store_layer<gfpp::OP_S1>(ops, npad, base, warp, lane, h, live_g, live_h);
        store_mask(relu, npad, 2, row_g, row_h, n, t, mg, mh);
      }
      fence_regs(acc);
      to_fragments<false, true>(acc, nullptr, h, t);
      float s8[4];
      uint32_t sh[4] = {0u, 0u, 0u, 0u};  // SH16 as the A fragment of col_w1's first k step
      layer<5>(ring, [&](int k, uint32_t b) {
        wgmma_m64n128k16_rs(acc, h[k], desc(b), k > 0);                          // geo
        wgmma_m64n8k16_rs(s8, h[k], desc(b + Layer<5>::kstep_bytes - 256), k > 0);  // sigma
      }, [&](int c) {
        if (c == 0) {  // while the first geo products run
          bf16 vg[16], vh[16];
          gfpp::sh16(dg, vg);
          gfpp::sh16(dh, vh);
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (t == q) {
              sh[0] = pack_bf16(__bfloat162float(vg[2 * q]), __bfloat162float(vg[2 * q + 1]));
              sh[1] = pack_bf16(__bfloat162float(vh[2 * q]), __bfloat162float(vh[2 * q + 1]));
              sh[2] = pack_bf16(__bfloat162float(vg[2 * q + 8]), __bfloat162float(vg[2 * q + 9]));
              sh[3] = pack_bf16(__bfloat162float(vh[2 * q + 8]), __bfloat162float(vh[2 * q + 9]));
            }
        }
      });
      if (stores) {
        relu_masks(h, mg, mh);
        store_layer<gfpp::OP_S2>(ops, npad, base, warp, lane, h, live_g, live_h);
        store_mask(relu, npad, 3, row_g, row_h, n, t, mg, mh);
      }
      fence_regs(acc);
      fence_regs(s8);

      // 4. sigma = exp(clip(logit, -15, 15)); colour input [SH16 | bf16(geo)]
      if (t == 0) {
        if (row_g < n) sigma_out[row_g] = expf(fminf(fmaxf(s8[0], -15.0f), 15.0f));
        if (row_h < n) sigma_out[row_h] = expf(fminf(fmaxf(s8[2], -15.0f), 15.0f));
        if (stores) {
          if (live_g) gate[row_g] = s8[0] > -15.0f && s8[0] < 15.0f;
          if (live_h) gate[row_h] = s8[2] > -15.0f && s8[2] < 15.0f;
        }
      }
      to_fragments<false, false>(acc, nullptr, h, t);

      // 5. colour MLP; the individual code enters through col_bias
      layer<6>(ring, [&](int k, uint32_t b) {
        if (k == 0)
          wgmma_m64n128k16_rs(acc, sh, desc(b), 0);
        else
          wgmma_m64n128k16_rs(acc, h[k > 0 ? k - 1 : 0], desc(b), 1);
      });
      if (stores) {  // g = [geo 128 | SH 16]: SH's fragments are core matrices 32..35
        store_layer<gfpp::OP_G>(ops, npad, base, warp, lane, h, live_g, live_h);
        uint32_t* dst = tile_dst<gfpp::OP_G>(ops, npad, base, warp, lane) + 32 * 32;
#pragma unroll
        for (int i = 0; i < 4; ++i) store_fragment(dst + 32 * i, sh[i], (i & 1) ? live_h : live_g);
      }
      fence_regs(acc);
      to_fragments<true, true>(acc, BIAS_COL, h, t);
      float c8[4];
      layer<7>(ring, [&](int k, uint32_t b) { wgmma_m64n8k16_rs(c8, h[k], desc(b), k > 0); });
      if (stores) {
        relu_masks(h, mg, mh);
        store_layer<gfpp::OP_C1>(ops, npad, base, warp, lane, h, live_g, live_h);
        store_mask(relu, npad, 4, row_g, row_h, n, t, mg, mh);
      }
      fence_regs(c8);
      if (t == 0) {
        if (row_g < n) {
          rgb_out[3 * row_g] = 1.0f / (1.0f + expf(-c8[0]));
          rgb_out[3 * row_g + 1] = 1.0f / (1.0f + expf(-c8[1]));
        }
        if (row_h < n) {
          rgb_out[3 * row_h] = 1.0f / (1.0f + expf(-c8[2]));
          rgb_out[3 * row_h + 1] = 1.0f / (1.0f + expf(-c8[3]));
        }
      } else if (t == 1) {
        if (row_g < n) rgb_out[3 * row_g + 2] = 1.0f / (1.0f + expf(-c8[0]));
        if (row_h < n) rgb_out[3 * row_h + 2] = 1.0f / (1.0f + expf(-c8[2]));
      }
      if (stores) {  // bf16(xyz), where the registers are free: lane t loads columns 2 t, 2 t + 1 (< 3)
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (t < 2) {
          if (live_g) v[0] = pinned_load(xyz + 3 * row_g + 2 * t);
          if (live_g && t == 0) v[1] = pinned_load(xyz + 3 * row_g + 1);
          if (live_h) v[2] = pinned_load(xyz + 3 * row_h + 2 * t);
          if (live_h && t == 0) v[3] = pinned_load(xyz + 3 * row_h + 1);
        }
        store_three<gfpp::OP_XYZB>(ops, npad, base, warp, lane, t < 2 ? pack_bf16(v[0], v[1]) : 0u,
                                   t < 2 ? pack_bf16(v[2], v[3]) : 0u, live_g, live_h);
      }
    }
  }
}

// One launch of an instantiation on `stream`; returns cudaGetLastError().
template <bool TRAIN>
int launch(const void* xyz, const void* dirs, int n, const void* packed, const void* pos_B, const void* amb_B,
           const void* amb_bias, const void* col_bias, void* sigma, void* rgb, void* amb, void* ops, int npad,
           void* relu, void* gate, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(fused_field_kernel<TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  // setmaxnreg's register moves assume the launch bound's full allocation
  // (ptxas gives it to a kernel that uses setmaxnreg); refuse, not hang
  cudaFuncAttributes attr;
  if ((err = cudaFuncGetAttributes(&attr, fused_field_kernel<TRAIN>)) != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs != LAUNCH_REGS) return static_cast<int>(cudaErrorInvalidConfiguration);
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return static_cast<int>(err);
  const int nsuper = (n + NCONS * TM - 1) / (NCONS * TM);
  const unsigned grid = static_cast<unsigned>(nsuper < sms ? nsuper : sms);
  fused_field_kernel<TRAIN><<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(dirs), n,
      static_cast<const unsigned char*>(packed), static_cast<const float*>(pos_B),
      static_cast<const float*>(amb_B), static_cast<const float*>(amb_bias),
      static_cast<const float*>(col_bias), static_cast<float*>(sigma), static_cast<float*>(rgb),
      static_cast<float*>(amb), static_cast<bf16*>(ops), npad, static_cast<uint32_t*>(relu),
      static_cast<unsigned char*>(gate));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Serving: launches on `stream` and returns cudaGetLastError() (0 on
// success). `packed` is pack_field_weights' stream (16-byte aligned,
// SPEC's layout).
int gfpp_fused_field_forward(const void* xyz, const void* dirs, int n, const void* packed,
                             const void* pos_B, const void* amb_B, const void* amb_bias,
                             const void* col_bias, void* sigma, void* rgb, void* amb, void* stream) {
  return launch<false>(xyz, dirs, n, packed, pos_B, amb_B, amb_bias, col_bias, sigma, rgb, amb, nullptr, 0,
                       nullptr, nullptr, stream);
}

// The train mode: the same outputs, and the backward's activation operands
// into `ops` (npad * OPERAND_ROWS bf16, npad = n rounded up to the 64-point
// tile; TRAIN_OPERANDS' rows only), the ReLU masks into `relu`
// (RELU_LAYERS * npad * RELU_WORDS uint32) and the sigma gate into `gate`
// (n bytes).
int gfpp_fused_field_forward_train(const void* xyz, const void* dirs, int n, const void* packed,
                                   const void* pos_B, const void* amb_B, const void* amb_bias,
                                   const void* col_bias, void* sigma, void* rgb, void* amb, void* ops, int npad,
                                   void* relu, void* gate, void* stream) {
  if (n > 0 && npad != (n + TM - 1) / TM * TM) return static_cast<int>(cudaErrorInvalidValue);
  return launch<true>(xyz, dirs, n, packed, pos_B, amb_B, amb_bias, col_bias, sigma, rgb, amb, ops, npad, relu,
                      gate, stream);
}

// The operands the train mode writes (TRAIN_OPERANDS, as Operand indices)
// into `out`; returns their number.
int gfpp_fused_field_train_operands(int* out, int cap) {
  for (int i = 0; i < gfpp::N_TRAIN_OPERANDS && i < cap; ++i) out[i] = gfpp::TRAIN_OPERANDS[i];
  return gfpp::N_TRAIN_OPERANDS;
}

// The weight stream's layout as the kernel reads it: row l of `spec` gets
// SPEC[l] (k16 steps, N, k16 steps per chunk). Returns the number of layers.
int gfpp_fused_field_layout(int* spec, int rows) {
  for (int l = 0; l < 8 && l < rows; ++l)
    for (int j = 0; j < 3; ++j) spec[3 * l + j] = SPEC[l][j];
  return 8;
}

// Points per consumer tile and per persistent step (the tests' ragged
// edges), and the block's dynamic shared memory in bytes.
int gfpp_fused_field_tile(int* tile, int* step, int* smem_bytes) {
  *tile = TM;
  *step = NCONS * TM;
  *smem_bytes = SMEM_BYTES;
  return 0;
}

const char* gfpp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
