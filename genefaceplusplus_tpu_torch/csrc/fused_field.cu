// Fused RAD-NeRF head-field forward for Hopper (sm_90a).
//
// Replaces the TPU kernel genefaceplusplus_tpu/ops/pallas/fused_field.py:_kernel
// (launched by fused_field_eval, pallas_call at :252). Per point it computes
//   xyz.B (f32) -> fast sin/cos -> ambient MLP x3 (cond folded into a bias row)
//   -> fast tanh -> ambient Fourier -> sigma MLP x3 -> exp(clip(., +-15)), geo
//   -> SH16(dirs) -> colour MLP x2 (ind code folded into a bias row) -> sigmoid
// at the flagship width (pos 128, amb 64, hidden 128, geo 128, cond 64).
//
// What bounds it on an H100: arithmetic. A point costs ~150k multiply-adds in
// nine small products (K <= 384, N <= 144) against 52 bytes of device traffic
// (xyz and dirs in, sigma, rgb and amb out), thousands of FLOP per byte, far
// above the card's bf16 ridge of ~295. The weights (~0.33 MB that are read)
// exceed a block's 227 KB of shared memory but stay resident in the 50 MB L2.
//
// What the design does about it: a block of 4 warps carries a tile of 64
// points through the whole chain. Activations never leave shared memory. Every
// product runs on the tensor cores (WMMA m16n16k16, bf16 inputs, f32
// accumulation); each warp owns whole 16-column strips of a layer's output for
// all 64 rows, so each weight fragment is read from L2 once per tile and used
// four times. The padding of the TPU layout is skipped: the narrow layers run
// 16 output columns (144 for sigma|geo), not 128 (256). Activations round to
// bf16 at the same places as the Pallas kernel (pos_feat, each post-ReLU
// hidden, amb_feat, geo, SH16); the Fourier projections and every
// nonlinearity stay f32 on the CUDA cores (FMAs, never TF32; expf, rintf and
// true division). Only live data moves: [N,3] inputs, [N] and [N,3] outputs,
// and the ragged last tile is masked here, with no host-side padding.
//
// Build (no PyTorch headers; loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libfused_field.so fused_field.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int TM = 64;                 // points per block
constexpr int NWARP = 4;
constexpr int NTHREAD = 32 * NWARP;
constexpr int AMB = 3;                 // ambient coordinate dim
constexpr int LDX = 384 + 8;           // [pos_feat 256 | amb_feat 128] bf16 rows
constexpr int LDH = 144 + 8;           // hidden, or [SH 16 | geo 128], bf16 rows
constexpr int LDC = 144 + 4;           // f32 product tile rows
constexpr int SMEM_X = sizeof(bf16) * TM * LDX;
constexpr int SMEM_H = sizeof(bf16) * TM * LDH;
constexpr int SMEM_C = sizeof(float) * TM * LDC;
constexpr int SMEM_P = sizeof(float) * TM * 9;  // xyz, dirs, ambient coordinate
constexpr int SMEM_BYTES = SMEM_X + SMEM_H + SMEM_C + SMEM_P;

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
// shared memory. Warp w computes the 16-column strips w, w+4, ... for all
// TM rows, so each W fragment is loaded once and used TM/16 times.
template <int K, int N, int LDA, int LDW>
__device__ __forceinline__ void tile_matmul(const bf16* A, const bf16* __restrict__ W, float* C) {
  const int warp = threadIdx.x >> 5;
  for (int nt = warp; nt < N / 16; nt += NWARP) {
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

// H[:, 0:128] = bf16(relu(C[:, 0:128] + bias)), bias optional
__device__ __forceinline__ void relu_to_bf16(const float* C, const float* __restrict__ bias, bf16* H) {
  for (int i = threadIdx.x; i < TM * 128; i += NTHREAD) {
    const int p = i >> 7, j = i & 127;
    float v = C[p * LDC + j];
    if (bias != nullptr) v += bias[j];
    H[p * LDH + j] = __float2bfloat16_rn(fmaxf(v, 0.0f));
  }
}

__global__ void __launch_bounds__(NTHREAD, 2) fused_field_kernel(
    const float* __restrict__ xyz,       // [n, 3]
    const float* __restrict__ dirs,      // [n, 3]
    int n,
    const float* __restrict__ pos_B,     // [8, 128] f32, rows 0..2 live (2 pi / bound folded in)
    const bf16* __restrict__ amb_w1,     // [384, 128], rows 0..255 (pos_feat) read
    const bf16* __restrict__ amb_w2,     // [128, 128]
    const bf16* __restrict__ amb_w3,     // [128, 128], columns 0..15 read (3 live)
    const float* __restrict__ amb_B,     // [128, 64] f32, rows 0..2 live (2 pi folded in)
    const bf16* __restrict__ sig_w1,     // [384, 128] rows: pos_feat 256 | amb_feat 128
    const bf16* __restrict__ sig_w2,     // [128, 128]
    const bf16* __restrict__ sig_w3,     // [128, 256], columns 0..143 read (129 live)
    const bf16* __restrict__ col_w1,     // [256, 128], rows 0..143 read (SH 16 | geo 128)
    const bf16* __restrict__ col_w2,     // [128, 128], columns 0..15 read (3 live)
    const float* __restrict__ amb_bias,  // [128] bf16(cond) . amb_w1[256:], as f32
    const float* __restrict__ col_bias,  // [128] bf16(ind) . col_w1[144:160], as f32
    float* __restrict__ sigma_out,       // [n]
    float* __restrict__ rgb_out,         // [n, 3]
    float* __restrict__ amb_out) {       // [n, 3]
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* X = reinterpret_cast<bf16*>(smem);
  bf16* H = reinterpret_cast<bf16*>(smem + SMEM_X);
  float* C = reinterpret_cast<float*>(smem + SMEM_X + SMEM_H);
  float* PX = reinterpret_cast<float*>(smem + SMEM_X + SMEM_H + SMEM_C);
  float* PD = PX + TM * 3;
  float* PA = PX + TM * 6;

  const int tid = threadIdx.x;
  const int base = blockIdx.x * TM;
  const int rows = min(TM, n - base);

  // 0. stage the tile's inputs; rows past the ragged end read zeros
  for (int i = tid; i < TM * 3; i += NTHREAD) {
    const bool live = i < rows * 3;
    PX[i] = live ? xyz[base * 3 + i] : 0.0f;
    PD[i] = live ? dirs[base * 3 + i] : 0.0f;
  }
  __syncthreads();

  // 1. position Fourier features, rounded to bf16
  for (int i = tid; i < TM * 128; i += NTHREAD) {
    const int p = i >> 7, f = i & 127;
    const float* x = PX + p * 3;
    const float proj = fmaf(x[2], pos_B[256 + f], fmaf(x[1], pos_B[128 + f], x[0] * pos_B[f]));
    X[p * LDX + f] = __float2bfloat16_rn(fast_sin(proj));
    X[p * LDX + 128 + f] = __float2bfloat16_rn(fast_cos(proj));
  }
  __syncthreads();

  // 2. ambient MLP; the condition enters through amb_bias
  tile_matmul<256, 128, LDX, 128>(X, amb_w1, C);
  __syncthreads();
  relu_to_bf16(C, amb_bias, H);
  __syncthreads();
  tile_matmul<128, 128, LDH, 128>(H, amb_w2, C);
  __syncthreads();
  relu_to_bf16(C, nullptr, H);
  __syncthreads();
  tile_matmul<128, 16, LDH, 128>(H, amb_w3, C);
  __syncthreads();

  // 3. ambient coordinate (f32) and its Fourier features
  for (int i = tid; i < TM * AMB; i += NTHREAD) {
    const int p = i / AMB, j = i % AMB;
    const float a = fast_tanh(C[p * LDC + j]);
    PA[i] = a;
    if (i < rows * AMB) amb_out[base * AMB + i] = a;
  }
  __syncthreads();
  for (int i = tid; i < TM * 64; i += NTHREAD) {
    const int p = i >> 6, f = i & 63;
    const float* a = PA + p * AMB;
    const float proj = fmaf(a[2], amb_B[128 + f], fmaf(a[1], amb_B[64 + f], a[0] * amb_B[f]));
    X[p * LDX + 256 + f] = __float2bfloat16_rn(fast_sin(proj));
    X[p * LDX + 320 + f] = __float2bfloat16_rn(fast_cos(proj));
  }
  __syncthreads();

  // 4. sigma MLP over [pos_feat | amb_feat]
  tile_matmul<384, 128, LDX, 128>(X, sig_w1, C);
  __syncthreads();
  relu_to_bf16(C, nullptr, H);
  __syncthreads();
  tile_matmul<128, 128, LDH, 128>(H, sig_w2, C);
  __syncthreads();
  relu_to_bf16(C, nullptr, H);
  __syncthreads();
  tile_matmul<128, 144, LDH, 256>(H, sig_w3, C);
  __syncthreads();

  // 5. sigma = exp(clip(logit, -15, 15)); colour input [SH16 | bf16(geo)]
  for (int p = tid; p < rows; p += NTHREAD)
    sigma_out[base + p] = expf(fminf(fmaxf(C[p * LDC], -15.0f), 15.0f));
  for (int i = tid; i < TM * 128; i += NTHREAD) {
    const int p = i >> 7, j = i & 127;
    H[p * LDH + 16 + j] = __float2bfloat16_rn(C[p * LDC + 1 + j]);
  }
  for (int p = tid; p < TM; p += NTHREAD) sh16(PD + p * 3, H + p * LDH);
  __syncthreads();

  // 6. colour MLP; the individual code enters through col_bias
  tile_matmul<144, 128, LDH, 128>(H, col_w1, C);
  __syncthreads();
  relu_to_bf16(C, col_bias, H);
  __syncthreads();
  tile_matmul<128, 16, LDH, 128>(H, col_w2, C);
  __syncthreads();
  for (int i = tid; i < rows * 3; i += NTHREAD) {
    const int p = i / 3, j = i % 3;
    rgb_out[base * 3 + i] = 1.0f / (1.0f + expf(-C[p * LDC + j]));
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
int gfpp_fused_field_forward(const void* xyz, const void* dirs, int n, const void* pos_B,
                             const void* amb_w1, const void* amb_w2, const void* amb_w3,
                             const void* amb_B, const void* sig_w1, const void* sig_w2,
                             const void* sig_w3, const void* col_w1, const void* col_w2,
                             const void* amb_bias, const void* col_bias, void* sigma,
                             void* rgb, void* amb, void* stream) {
  if (n <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_field_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((n + TM - 1) / TM);
  fused_field_kernel<<<grid, NTHREAD, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(dirs), n,
      static_cast<const float*>(pos_B), static_cast<const bf16*>(amb_w1),
      static_cast<const bf16*>(amb_w2), static_cast<const bf16*>(amb_w3),
      static_cast<const float*>(amb_B), static_cast<const bf16*>(sig_w1),
      static_cast<const bf16*>(sig_w2), static_cast<const bf16*>(sig_w3),
      static_cast<const bf16*>(col_w1), static_cast<const bf16*>(col_w2),
      static_cast<const float*>(amb_bias), static_cast<const float*>(col_bias),
      static_cast<float*>(sigma), static_cast<float*>(rgb), static_cast<float*>(amb));
  return static_cast<int>(cudaGetLastError());
}

const char* gfpp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
