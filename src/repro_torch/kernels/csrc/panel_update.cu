// C <- C - A B, summed in float32, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `panel_update` in
// src/repro/kernels/panel_update.py (the trailing-tile update of the
// Block-ILU(k) numeric phase, A_JT -= L_JI U_IT): the product is computed
// in this kernel's own body, as the Pallas kernel computes it in its.
//
// Shapes: A (M, K), B (K, N), C and the output (M, N), all row-major, with
// M, N and K any sizes (the ragged edge is masked here, where the JAX
// wrapper pads). The output may be C itself: every thread reads
// the C entries it owns before it writes them, and no other thread touches
// them. It must not overlap A or B (the wrapper checks).
//
// Types: all four float32, or all four bfloat16 (the Pallas kernel's bf16
// form: bf16 inputs, float32 accumulation, the output in C's type). One
// body, templated on the element type: loads widen to float32
// (__bfloat162float), the sum and the subtract are float32, and the store
// rounds to nearest (__float2bfloat16_rn).
//
// Arithmetic: each output's sum runs over k ascending, one __fmaf_rn per
// term, from +0.0; then out = __fsub_rn(c, sum). The Pallas kernel sums in
// blocks of 128 along k with the MXU's own order, and the plain version
// (torch's matrix product) in yet another, so the three agree to a
// tolerance of order K * 2^-24 * (|C| + |A||B|), not bitwise.
//
// Bound: at the Block-ILU shape (128, 128) x (128, 128) one call moves
// 256 KB (128 KB in bf16) and does 4.2 MFLOP, about 0.08 us at 3.35 TB/s:
// far below one launch, so a call is launch-bound and this kernel is a
// plain tiled SGEMM on the CUDA cores. Design: 64 x 64 output blocks, 256 threads each
// computing a 4 x 4 patch, k staged through shared memory 16 at a time
// (A stored transposed so both operands are read along a row). Tensor
// cores (TF32 would change the result), wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define BM 64
#define BN 64
#define BK 16

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(256)
panel_update_kernel(const T* c, const T* __restrict__ a, const T* __restrict__ b, T* out, int m,
                    int n, int k) {
  __shared__ float as[BK][BM];  // as[kk][row] = A[row0 + row, k0 + kk]
  __shared__ float bs[BK][BN];  // bs[kk][col] = B[k0 + kk, col0 + col]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // 1024 entries of each operand tile, four per thread; zeros past the edge
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = threadIdx.x + q * 256;
      const int ar = e / BK, ak = e % BK;  // A: 64 rows x 16 k, k fastest
      const int gr = row0 + ar, gk = k0 + ak;
      as[ak][ar] = (gr < m && gk < k) ? widen(a[(size_t)gr * k + gk]) : 0.0f;
      const int bk = e / BN, bc = e % BN;  // B: 16 k x 64 cols, cols fastest
      const int hk = k0 + bk, hc = col0 + bc;
      bs[bk][bc] = (hk < k && hc < n) ? widen(b[(size_t)hk * n + hc]) : 0.0f;
    }
    __syncthreads();
    const int kmax = min(BK, k - k0);  // the zero padding never enters a sum
    for (int kk = 0; kk < kmax; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx * 4 + j;
      if (col < n) {
        const size_t at = (size_t)r * n + col;
        store(out + at, __fsub_rn(widen(c[at]), acc[i][j]));
      }
    }
  }
}

template <typename T>
static int launch(const void* c, const void* a, const void* b, void* out, int m, int n, int k,
                  cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  panel_update_kernel<T><<<grid, 256, 0, stream>>>((const T*)c, (const T*)a, (const T*)b,
                                                   (T*)out, m, n, k);
  return (int)cudaGetLastError();
}

// bf16 != 0: every operand and the output are bfloat16; else float32.
extern "C" int panel_update_launch(const void* c, const void* a, const void* b, void* out,
                                   int m, int n, int k, int bf16, void* stream) {
  return bf16 ? launch<__nv_bfloat16>(c, a, b, out, m, n, k, (cudaStream_t)stream)
              : launch<float>(c, a, b, out, m, n, k, (cudaStream_t)stream);
}
