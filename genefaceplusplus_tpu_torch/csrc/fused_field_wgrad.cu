// Weight gradients of the fused RAD-NeRF head field for Hopper (sm_90a).
//
// Replaces, with fused_field_bwd.cu (the tile chain), the TPU kernel
// genefaceplusplus_tpu/ops/pallas/fused_field.py:_bwd_kernel: its
// weight-gradient dots (:347-383) and their sums over all points (_acc
// :386, _acc_row0 :396). The chain writes the bf16 operands of every
// product (fused_field_common.cuh, Operand); this kernel computes, for each
// of the 14 gradient blocks, sum over points p of act[p, i] . g[p, j] with
// f32 sums, and a second kernel adds the chunks' partials in order.
//
// What bounds it on an H100: bytes. A point's operands are 4,282 bf16
// bytes at live widths (4,336 as stored) against 150,976 multiply-adds: at
// 1,048,576 points 1.34 ms of HBM reads against 0.32 ms of bf16
// tensor-core work.
//
// Design:
// * A work item is one (item, chunk): a fixed set of operands streamed
//   over WGRAD_CHUNK points, and the products of that set (ITEMS, mirrored
//   by ops/fused_field.py:WGRAD_ITEMS and checked when the library loads).
//   Each item is its own kernel (one block per chunk), so each holds only
//   its own accumulators: one kernel holding all eleven items' code ran out
//   of registers, spilled, and had ptxas serialize its wgmmas (C7511/C7512).
//   The split is a fixed function of n, every (item, chunk) writes its f32
//   partial once, and the reduction adds the partials in chunk order: no
//   atomics, bit-identical gradients run to run.
// * Each product is wgmma m64nNk16 (N = 128 or 8) with both operands in
//   shared memory: M is a 64-row block of one operand, N rows of another
//   (K = points). Its f32 accumulator stays in the consumer warpgroup's
//   registers for the whole chunk. A bias row is the product of a gradient
//   with a constant [1, 0 x 7] operand (ONES) that never leaves shared
//   memory. Where the gradient is the M side, the epilogue writes the
//   block transposed.
// * The operands are stored K-major in sm90.cuh's unswizzled layout, so a
//   stage (SK k16 steps, 64 points) of one operand is one contiguous bulk
//   copy. One producer thread keeps NSTAGE stages (at most 3 x 30,720
//   bytes, ~92 KB) in flight (mbarriers full/empty) for the block's
//   consumer warpgroup; one block per chunk.
// * The items run one after another, so a gradient operand that several
//   items read (gs1 by five, ga1 by four) is read from HBM each time: 6,384
//   bytes a point in all, against the 4,282 the bound counts.
//
// Build (no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_field_wgrad.so fused_field_wgrad.cu

#include <array>
#include <initializer_list>
#include <utility>

#include "fused_field_common.cuh"
#include "sm90.cuh"

using namespace gfpp;
using namespace gfpp::sm90;

namespace {

constexpr int SK = 4;         // k16 steps (64 points) a stage
constexpr int NSTAGE = 3;     // operand ring depth
constexpr int CHUNK = 8192;   // points a work item sums (ops/fused_field.py, WGRAD_CHUNK)
constexpr int NTHREAD = 160;  // one consumer warpgroup, one producer warp
constexpr int ONES = -1;      // the constant [1, 0 x 7] N operand

// the packed gradient: the live regions of the 14 blocks of
// _fused_backward, in its order, each row-major (ops/fused_field.py, GRAD_BLOCKS)
enum Block {
  B_POS_B, B_AMB_W1P, B_AMB_BIAS, B_AMB_W2, B_AMB_W3, B_AMB_B, B_SIG_W1P,
  B_SIG_W1A, B_SIG_W2, B_SIG_W3, B_COL_W1S, B_COL_W1G, B_COL_BIAS, B_COL_W2, N_BLOCKS
};
constexpr int LIVE[N_BLOCKS][2] = {{3, 128},   {256, 128}, {1, 128}, {128, 128}, {128, 3},
                                   {3, 64},    {256, 128}, {128, 128}, {128, 128}, {128, 129},
                                   {16, 128},  {128, 128}, {1, 128}, {128, 3}};

__host__ __device__ constexpr int block_off(int b) {
  int off = 0;
  for (int i = 0; i < b; ++i) off += LIVE[i][0] * LIVE[i][1];
  return off;
}
constexpr int PACKED = block_off(N_BLOCKS);  // 151,232 floats
static_assert(PACKED == 151232, "packed gradient");

// D[i, j] = sum_p M[p, 64 m_blk + i] . N[p, n_row + j]; for j < live it
// goes to block[row0 + i, col0 + j], or to block[row0 + j, col0 + i] if trans
struct Prod {
  int m_op, m_blk, n_op, n_row, n_w, block, row0, col0, live, trans;
};
constexpr int MAXOPS = 8, MAXPROD = 8;
struct Item {
  int nops;
  int ops[MAXOPS];  // the operands a stage holds, in this order
  int nprod;
  Prod prod[MAXPROD];
};

constexpr Item ITEMS[] = {
    {3, {OP_X0, OP_GS1, OP_GA1}, 4,
     {{OP_X0, 0, OP_GS1, 0, 128, B_SIG_W1P, 0, 0, 128, 0},
      {OP_X0, 0, OP_GA1, 0, 128, B_AMB_W1P, 0, 0, 128, 0},
      {OP_GA1, 0, ONES, 0, 8, B_AMB_BIAS, 0, 0, 1, 1},
      {OP_GA1, 1, ONES, 0, 8, B_AMB_BIAS, 0, 64, 1, 1}}},
    {3, {OP_X1, OP_GS1, OP_GA1}, 2,
     {{OP_X1, 0, OP_GS1, 0, 128, B_SIG_W1P, 64, 0, 128, 0},
      {OP_X1, 0, OP_GA1, 0, 128, B_AMB_W1P, 64, 0, 128, 0}}},
    {3, {OP_X2, OP_GS1, OP_GA1}, 2,
     {{OP_X2, 0, OP_GS1, 0, 128, B_SIG_W1P, 128, 0, 128, 0},
      {OP_X2, 0, OP_GA1, 0, 128, B_AMB_W1P, 128, 0, 128, 0}}},
    {3, {OP_X3, OP_GS1, OP_GA1}, 2,
     {{OP_X3, 0, OP_GS1, 0, 128, B_SIG_W1P, 192, 0, 128, 0},
      {OP_X3, 0, OP_GA1, 0, 128, B_AMB_W1P, 192, 0, 128, 0}}},
    {2, {OP_XA, OP_GS1}, 2,
     {{OP_XA, 0, OP_GS1, 0, 128, B_SIG_W1A, 0, 0, 128, 0},
      {OP_XA, 1, OP_GS1, 0, 128, B_SIG_W1A, 64, 0, 128, 0}}},
    {2, {OP_A1, OP_GA2}, 2,
     {{OP_A1, 0, OP_GA2, 0, 128, B_AMB_W2, 0, 0, 128, 0},
      {OP_A1, 1, OP_GA2, 0, 128, B_AMB_W2, 64, 0, 128, 0}}},
    {2, {OP_S1, OP_GS2}, 2,
     {{OP_S1, 0, OP_GS2, 0, 128, B_SIG_W2, 0, 0, 128, 0},
      {OP_S1, 1, OP_GS2, 0, 128, B_SIG_W2, 64, 0, 128, 0}}},
    {2, {OP_S2, OP_GSIG}, 4,
     {{OP_S2, 0, OP_GSIG, 0, 128, B_SIG_W3, 0, 1, 128, 0},
      {OP_S2, 0, OP_GSIG, 128, 8, B_SIG_W3, 0, 0, 1, 0},
      {OP_S2, 1, OP_GSIG, 0, 128, B_SIG_W3, 64, 1, 128, 0},
      {OP_S2, 1, OP_GSIG, 128, 8, B_SIG_W3, 64, 0, 1, 0}}},
    {2, {OP_GC1A, OP_G}, 4,
     {{OP_GC1A, 0, OP_G, 0, 128, B_COL_W1G, 0, 0, 128, 1},
      {OP_GC1A, 0, OP_G, 128, 8, B_COL_W1S, 0, 0, 8, 1},
      {OP_GC1A, 0, OP_G, 136, 8, B_COL_W1S, 8, 0, 8, 1},
      {OP_GC1A, 0, ONES, 0, 8, B_COL_BIAS, 0, 0, 1, 1}}},
    {2, {OP_GC1B, OP_G}, 4,
     {{OP_GC1B, 0, OP_G, 0, 128, B_COL_W1G, 0, 64, 128, 1},
      {OP_GC1B, 0, OP_G, 128, 8, B_COL_W1S, 0, 64, 8, 1},
      {OP_GC1B, 0, OP_G, 136, 8, B_COL_W1S, 8, 64, 8, 1},
      {OP_GC1B, 0, ONES, 0, 8, B_COL_BIAS, 0, 64, 1, 1}}},
    {8, {OP_A2, OP_C1, OP_GAPROJ, OP_GPROJ, OP_GAMB, OP_GRGB, OP_APOS, OP_XYZB}, 7,
     {{OP_A2, 0, OP_GAMB, 0, 8, B_AMB_W3, 0, 0, 3, 0},
      {OP_A2, 1, OP_GAMB, 0, 8, B_AMB_W3, 64, 0, 3, 0},
      {OP_C1, 0, OP_GRGB, 0, 8, B_COL_W2, 0, 0, 3, 0},
      {OP_C1, 1, OP_GRGB, 0, 8, B_COL_W2, 64, 0, 3, 0},
      {OP_GAPROJ, 0, OP_APOS, 0, 8, B_AMB_B, 0, 0, 3, 1},
      {OP_GPROJ, 0, OP_XYZB, 0, 8, B_POS_B, 0, 0, 3, 1},
      {OP_GPROJ, 1, OP_XYZB, 0, 8, B_POS_B, 0, 64, 3, 1}}},
};
constexpr int NITEMS = sizeof(ITEMS) / sizeof(ITEMS[0]);

// byte offset of operand `op` in a stage of item i (-1 if it has none)
__host__ __device__ constexpr int stage_off(int i, int op) {
  int off = 0;
  for (int k = 0; k < ITEMS[i].nops; ++k) {
    if (ITEMS[i].ops[k] == op) return off;
    off += SK * OP_ROWS[ITEMS[i].ops[k]] * 32;
  }
  return -1;
}

__host__ __device__ constexpr int stage_bytes(int i) {
  int bytes = 0;
  for (int k = 0; k < ITEMS[i].nops; ++k) bytes += SK * OP_ROWS[ITEMS[i].ops[k]] * 32;
  return bytes;
}

// accumulator registers of products 0 .. p - 1 of item i
__host__ __device__ constexpr int acc_regs(int i, int p) {
  int a = 0;
  for (int k = 0; k < p; ++k) a += ITEMS[i].prod[k].n_w / 2;
  return a;
}

// products 0 .. p - 1 of item i with N = 128 (the others have N = 8)
__host__ __device__ constexpr int wide_before(int i, int p) {
  int c = 0;
  for (int k = 0; k < p; ++k) c += ITEMS[i].prod[k].n_w == 128;
  return c;
}

__host__ __device__ constexpr int max_stage_bytes() {
  int m = 0;
  for (int i = 0; i < NITEMS; ++i) m = stage_bytes(i) > m ? stage_bytes(i) : m;
  return m;
}

// every product reads operands its item streams, inside their rows, and
// writes inside its block's live region
__host__ __device__ constexpr bool items_valid() {
  for (int i = 0; i < NITEMS; ++i) {
    const Item& it = ITEMS[i];
    if (it.nops > MAXOPS || it.nprod > MAXPROD) return false;
    for (int p = 0; p < it.nprod; ++p) {
      const Prod& q = it.prod[p];
      if (stage_off(i, q.m_op) < 0 || 64 * (q.m_blk + 1) > OP_ROWS[q.m_op]) return false;
      if (q.n_w != 8 && q.n_w != 128) return false;
      if (q.n_op != ONES && (stage_off(i, q.n_op) < 0 || q.n_row + q.n_w > OP_ROWS[q.n_op])) return false;
      if (q.n_op == ONES && (q.n_w != 8 || q.live != 1)) return false;
      const int rows = q.trans ? q.live : 64, cols = q.trans ? 64 : q.live;
      if (q.live > q.n_w || q.row0 + rows > LIVE[q.block][0] || q.col0 + cols > LIVE[q.block][1]) return false;
    }
    if (acc_regs(i, it.nprod) > 136) return false;  // the accumulators of one warpgroup
  }
  return true;
}
static_assert(items_valid(), "ITEMS");

constexpr int STAGE_BYTES = max_stage_bytes();  // 30,720
constexpr int OFF_ONES = NSTAGE * STAGE_BYTES;
constexpr int OFF_BAR = OFF_ONES + 256;
constexpr int SMEM_BYTES = OFF_BAR + 2 * NSTAGE * 8;
static_assert(STAGE_BYTES % 128 == 0 && SMEM_BYTES <= 232448, "shared memory");
static_assert(CHUNK % (16 * SK) == 0 && 64 % (16 * SK) == 0, "whole stages in every chunk");

template <class F, int... Is>
__device__ __forceinline__ void static_for_impl(F& f, std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}

// f(std::integral_constant<int, i>) for i = 0 .. N - 1
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// the ring's read side, as the consumer warpgroup walks it
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint32_t base;  // shared address of stage 0
  int stage, prev;
  uint32_t phase;

  __device__ __forceinline__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);  // one arrival per consumer warp
  }
  __device__ __forceinline__ void advance() {
    prev = stage;
    if (++stage == NSTAGE) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

// The producer's side of one work item: each stage of k steps [k0, k1)
// into the next free slot, one bulk copy per operand.
template <int I>
__device__ __forceinline__ void produce(const bf16* __restrict__ ops, int npad, int k0, int k1,
                                        unsigned char* smem, uint64_t* full, uint64_t* empty, int& stage,
                                        uint32_t& phase) {
  constexpr int NOPS = ITEMS[I].nops, BYTES = stage_bytes(I);
  for (int k = k0; k < k1; k += SK) {
    mbar_wait(&empty[stage], phase ^ 1u);
    mbar_arrive_expect_tx(&full[stage], BYTES);
    unsigned char* dst = smem + stage * STAGE_BYTES;
    static_for<NOPS>([&](auto oc) {
      constexpr int O = ITEMS[I].ops[decltype(oc)::value];
      constexpr int R = OP_ROWS[O];
      constexpr size_t FIRST = op_first_row(O);
      constexpr int OFF = stage_off(I, O);
      bulk_copy(dst + OFF, ops + static_cast<size_t>(npad) * FIRST + static_cast<size_t>(k) * R * 16,
                SK * R * 32, &full[stage]);
    });
    if (++stage == NSTAGE) {
      stage = 0;
      phase ^= 1u;
    }
  }
}

// The consumer's side of one work item: the products of k steps [k0, k1)
// into registers, then the chunk's partial.
template <int I>
__device__ __forceinline__ void consume(Ring& r, int k0, int k1, uint32_t ones, float* __restrict__ part) {
  constexpr int NPROD = ITEMS[I].nprod, NWIDE = wide_before(I, NPROD);
  // product p's accumulator: wide[wide_before(I, p)] for N = 128, else
  // narrow[p - wide_before(I, p)]; whole arrays, so they stay in registers
  float wide[NWIDE > 0 ? NWIDE : 1][64];
  float narrow[NPROD - NWIDE > 0 ? NPROD - NWIDE : 1][4];
#pragma unroll 1
  for (int k = k0; k < k1; k += SK) {
    mbar_wait(&r.full[r.stage], r.phase);
    const uint32_t base = r.base + r.stage * STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      const int accumulate = k > k0 || kk > 0;
      static_for<NPROD>([&](auto pc) {
        constexpr int P = decltype(pc)::value, W = wide_before(I, P);
        constexpr Prod q = ITEMS[I].prod[P];
        constexpr int A_OFF = stage_off(I, q.m_op) + q.m_blk * 2048, A_STEP = OP_ROWS[q.m_op] * 32;
        constexpr int B_OFF = q.n_op == ONES ? 0 : stage_off(I, q.n_op) + q.n_row * 32;
        constexpr int B_STEP = q.n_op == ONES ? 0 : OP_ROWS[q.n_op] * 32;
        const uint64_t da = desc(base + A_OFF + kk * A_STEP);
        const uint64_t db = desc(q.n_op == ONES ? ones : base + B_OFF + kk * B_STEP);
        if constexpr (q.n_w == 128)
          wgmma_m64n128k16_ss(wide[W], da, db, accumulate);
        else
          wgmma_m64n8k16_ss(narrow[P - W], da, db, accumulate);
      });
    }
    wgmma_commit();
    if (k > k0) {
      wgmma_wait<1>();  // the previous stage's products are done with it
      r.release(r.prev);
    }
    r.advance();
  }
  wgmma_wait<0>();
  r.release(r.prev);
#pragma unroll
  for (int i = 0; i < NWIDE; ++i) fence_regs(wide[i]);
#pragma unroll
  for (int i = 0; i < NPROD - NWIDE; ++i) fence_regs(narrow[i]);

  // accumulator register q of m64nN: row 16 warp + g (+ 8 if q & 2), column 8 (q / 4) + 2 t + (q & 1)
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  static_for<NPROD>([&](auto pc) {
    constexpr int P = decltype(pc)::value, W = wide_before(I, P);
    constexpr Prod q = ITEMS[I].prod[P];
    constexpr int LD = LIVE[q.block][1], BASE = block_off(q.block) + q.row0 * LD + q.col0;
#pragma unroll
    for (int e = 0; e < q.n_w / 2; ++e) {
      const int col = 8 * (e >> 2) + 2 * t + (e & 1), row = 16 * warp + g + ((e & 2) ? 8 : 0);
      float v;
      if constexpr (q.n_w == 128)
        v = wide[W][e];
      else
        v = narrow[P - W][e];
      if (col < q.live) part[q.trans ? BASE + col * LD + row : BASE + row * LD + col] = v;
    }
  });
}

// Work item (I, blockIdx.x): item I over chunk blockIdx.x.
template <int I>
__global__ void __launch_bounds__(NTHREAD, 1) fused_field_wgrad_kernel(
    const bf16* __restrict__ ops,  // the chain's operands (fused_field_common.cuh, Operand)
    int npad,                      // points each operand holds (a multiple of 64)
    float* __restrict__ partial) {  // [nchunks, PACKED]
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + NSTAGE;

  // ONES: an 8-row N operand of one k16 step, row 0 all ones (two core
  // matrices of 8 rows x 8 bf16); every k step reads the same block
  if (threadIdx.x < 128) {
    const int e = threadIdx.x;
    reinterpret_cast<bf16*>(smem + OFF_ONES)[e] = __float2bfloat16_rn(((e & 63) >> 3) == 0 ? 1.0f : 0.0f);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < NSTAGE; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);  // one arrival per consumer warp
    }
    fence_mbar_init();
  }
  fence_proxy_async();  // the ONES block, to the products that read it
  __syncthreads();

  const int k0 = blockIdx.x * (CHUNK / 16), k1 = min(k0 + CHUNK / 16, npad / 16);
  if (threadIdx.x >= 128) {
    if (threadIdx.x == 128) {  // producer: one thread streams the chunk's operands
      int stage = 0;
      uint32_t phase = 0;
      produce<I>(ops, npad, k0, k1, smem, full, empty, stage, phase);
    }
  } else {  // consumer warpgroup
    Ring ring{full, empty, smem_addr(smem), 0, 0, 0u};
    consume<I>(ring, k0, k1, smem_addr(smem + OFF_ONES), partial + static_cast<size_t>(blockIdx.x) * PACKED);
  }
}

typedef void (*ItemKernel)(const bf16*, int, float*);

template <int... Is>
constexpr std::array<ItemKernel, sizeof...(Is)> item_kernels(std::integer_sequence<int, Is...>) {
  return {fused_field_wgrad_kernel<Is>...};
}

// out[j] = sum over chunks c in order of partial[c, j]
__global__ void __launch_bounds__(256) reduce_kernel(const float* __restrict__ partial, int nchunks,
                                                     float* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= PACKED) return;
  float s = 0.0f;
  for (int c = 0; c < nchunks; ++c) s += partial[static_cast<size_t>(c) * PACKED + j];
  out[j] = s;
}

}  // namespace

extern "C" {

// Launches the weight-gradient kernel on `stream`, one launch per item over
// all chunks, and returns the first CUDA error (0 on success). `ops`: the chain's operands for npad
// points (a multiple of 64); `partial`: scratch of nchunks * PACKED floats,
// nchunks = ceil(npad / CHUNK).
int gfpp_fused_field_wgrad(const void* ops, int npad, void* partial, int nchunks, void* stream) {
  if (npad <= 0 || npad % 64 != 0 || nchunks != (npad + CHUNK - 1) / CHUNK)
    return static_cast<int>(cudaErrorInvalidValue);
  for (ItemKernel k : item_kernels(std::make_integer_sequence<int, NITEMS>{})) {
    cudaError_t err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    k<<<nchunks, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(ops), npad, static_cast<float*>(partial));
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// out[PACKED] = the partials summed in chunk order
int gfpp_fused_field_wgrad_reduce(const void* partial, int nchunks, void* out, void* stream) {
  if (nchunks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  reduce_kernel<<<(PACKED + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), nchunks, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The kernel's tables as ints, in ops/fused_field.py:wgrad_table's order:
// operand rows, the blocks' live regions, CHUNK, then each item's operands
// and products. Writes at most `cap`; returns the table's length.
int gfpp_fused_field_wgrad_layout(int* out, int cap) {
  int n = 0;
  auto put = [&](int v) {
    if (n < cap) out[n] = v;
    ++n;
  };
  put(N_OPERANDS);
  for (int o = 0; o < N_OPERANDS; ++o) put(OP_ROWS[o]);
  put(N_BLOCKS);
  for (int b = 0; b < N_BLOCKS; ++b) {
    put(LIVE[b][0]);
    put(LIVE[b][1]);
  }
  put(CHUNK);
  put(NITEMS);
  for (const Item& it : ITEMS) {
    put(it.nops);
    for (int k = 0; k < it.nops; ++k) put(it.ops[k]);
    put(it.nprod);
    for (int p = 0; p < it.nprod; ++p) {
      const Prod& q = it.prod[p];
      for (int v : {q.m_op, q.m_blk, q.n_op, q.n_row, q.n_w, q.block, q.row0, q.col0, q.live, q.trans}) put(v);
    }
  }
  return n;
}

const char* gfpp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
