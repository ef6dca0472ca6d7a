// The two dense-tile triangular solves of Block-ILU(k), for Hopper (sm_90a).
//
// Replaces the Pallas kernels `trsm_right_upper` and `trsm_left_unit_lower`
// in src/repro/kernels/tri_solve.py:
//
// * trsm_right_upper:  X U = A for A (M, bs), U (bs, bs) upper: the L-panel
//   step L_JI = A_JI U_II^{-1}. Rows of X are independent; each is a
//   column substitution
//       x[r, c] = (a[r, c] - sum_{j<c} x[r, j] u[j, c]) / u[c, c].
// * trsm_left_unit_lower:  L X = A for L (bs, bs) unit-lower, A (bs, N): the
//   U-panel step U_IJ = L_II^{-1} A_IJ. Columns are independent; each is a
//   row substitution
//       x[r, c] = a[r, c] - sum_{j<r} l[r, j] x[j, c].
//
// Arithmetic: the sums run in ascending j from +0.0, one __fmul_rn product
// rounded before each __fadd_rn add, then __fsub_rn and (right solve)
// __fdiv_rn: the order of the plain versions in kernels/ref.py, which these
// kernels equal bitwise. Only the triangle a solve needs is read: entries of
// U below its diagonal, and of L on and above it, never are, so the packed
// LU tile of the pivot can be passed as it is (the Pallas kernel masks them
// the same way, tri_solve.py:33,48).
//
// Bound: one (128, 128) solve moves 192 KB (a, the triangle, x), about
// 0.06 us at 3.35 TB/s, and does ~2 MFLOP; so a call is launch-bound, and
// the substitution itself is a chain of bs dependent steps per row or
// column. Design: one warp per block, one thread per panel row (right) or
// column (left), so a (128, 128) panel is four blocks on four SMs. A
// block's 32 rows or columns sit in shared memory (33 * bs or 32 * bs
// floats, padded so that the warp's accesses hit 32 different banks),
// loaded coalesced, overwritten in place as the substitution goes, and
// stored coalesced; the triangle's entries are the same address for the
// whole warp (a broadcast) and are read through the read-only cache. The
// output may be the input panel itself (each block loads its part before
// it writes it); it must not overlap the triangle (the wrapper checks).
#include <cuda_runtime.h>

#define LANES 32
#define RSTRIDE 33  // right solve: x[r, c] at c * RSTRIDE + r

__global__ void __launch_bounds__(LANES)
trsm_right_upper_kernel(const float* a, const float* __restrict__ u, float* out, int m,
                        int bs) {
  extern __shared__ float sx[];
  const int r0 = blockIdx.x * LANES, tid = threadIdx.x;
  for (int e = tid; e < LANES * bs; e += LANES) {
    const int r = e / bs, c = e % bs;
    sx[c * RSTRIDE + r] = (r0 + r < m) ? a[(size_t)(r0 + r) * bs + c] : 0.0f;
  }
  __syncthreads();
  if (r0 + tid < m) {
    for (int c = 0; c < bs; ++c) {
      float acc = 0.0f;
      for (int j = 0; j < c; ++j)
        acc = __fadd_rn(acc, __fmul_rn(sx[j * RSTRIDE + tid], __ldg(u + (size_t)j * bs + c)));
      sx[c * RSTRIDE + tid] =
          __fdiv_rn(__fsub_rn(sx[c * RSTRIDE + tid], acc), __ldg(u + (size_t)c * bs + c));
    }
  }
  __syncthreads();
  for (int e = tid; e < LANES * bs; e += LANES) {
    const int r = e / bs, c = e % bs;
    if (r0 + r < m) out[(size_t)(r0 + r) * bs + c] = sx[c * RSTRIDE + r];
  }
}

__global__ void __launch_bounds__(LANES)
trsm_left_unit_lower_kernel(const float* __restrict__ l, const float* a, float* out, int bs,
                            int n) {
  extern __shared__ float sx[];  // x[r, c0 + tid] at r * LANES + tid
  const int c0 = blockIdx.x * LANES, tid = threadIdx.x;
  const bool live = c0 + tid < n;
  for (int r = 0; r < bs; ++r) sx[r * LANES + tid] = live ? a[(size_t)r * n + c0 + tid] : 0.0f;
  __syncthreads();
  if (live) {
    for (int r = 0; r < bs; ++r) {
      float acc = 0.0f;
      for (int j = 0; j < r; ++j)
        acc = __fadd_rn(acc, __fmul_rn(__ldg(l + (size_t)r * bs + j), sx[j * LANES + tid]));
      sx[r * LANES + tid] = __fsub_rn(sx[r * LANES + tid], acc);
    }
  }
  __syncthreads();
  if (live)
    for (int r = 0; r < bs; ++r) out[(size_t)r * n + c0 + tid] = sx[r * LANES + tid];
}

// Shared memory above 48 KB must be asked for per kernel (bs > 372 here).
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int trsm_right_upper_launch(const void* a, const void* u, void* out, int m, int bs,
                                       void* stream) {
  const size_t smem = (size_t)RSTRIDE * bs * sizeof(float);
  cudaError_t err = allow_smem(trsm_right_upper_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  trsm_right_upper_kernel<<<(m + LANES - 1) / LANES, LANES, smem, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)u, (float*)out, m, bs);
  return (int)cudaGetLastError();
}

extern "C" int trsm_left_unit_lower_launch(const void* l, const void* a, void* out, int bs,
                                           int n, void* stream) {
  const size_t smem = (size_t)LANES * bs * sizeof(float);
  cudaError_t err = allow_smem(trsm_left_unit_lower_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  trsm_left_unit_lower_kernel<<<(n + LANES - 1) / LANES, LANES, smem, (cudaStream_t)stream>>>(
      (const float*)l, (const float*)a, (float*)out, bs, n);
  return (int)cudaGetLastError();
}
