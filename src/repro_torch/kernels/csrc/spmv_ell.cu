// y = A x over sentinel-padded ELL rows, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `spmv_ell` in src/repro/kernels/spmv_ell.py
// (the GMRES matvec of the single-device solve), in its single form and
// in the (nb, n) form of the batched solve.
//
// Arithmetic: lane-ordered accumulation from +0.0, one __fmul_rn product
// rounded before each __fadd_rn add, exactly as masked_lane_sum in the
// reference. Lanes with col >= COL_SENTINEL are skipped, never gathered:
// the reference adds +0.0 for them, which cannot change an accumulator that
// started at +0.0. A gather is clamped to n-1, as in the Pallas kernel. The
// build passes -fmad=false as a second guard.
//
// Bound: bytes. Each row reads W column indices, W values and W gathered x
// entries and writes one float, about 8 bytes per stored entry plus the
// vectors, against 2 flops per entry. Design: one thread per row, so that a
// warp streams 32 consecutive rows; x (640 KB at the main size) stays in L2
// for the gathers. The ELL arrays are read row-major, as the wrapper is
// given them (no copy): a warp's lane-q loads are strided by W, and a
// lane-major copy, which would coalesce them, was no faster on the main
// path's matrix (W = 5), so the port keeps one layout. The m rows
// may be a row block of a larger matrix (m != n): the distributed path's
// owners each reduce their own block against the whole x.
//
// A thread loads LANE_CHUNK lanes' columns and values at once, then their
// gathers, then adds the products in ascending lane order: the loads of a
// chunk overlap, and the order of the rounded operations is unchanged (a
// padded or sentinel lane is never added; its value is loaded, unused).
//
// Batched form: a thread reads its row's columns and values once per chunk
// of NBC right-hand sides (NBC = min(nb, 8), accumulators in registers)
// and adds each product into that right-hand side's own sum; the sums
// never mix, so a row's bits do not depend on nb. Chunks of 8 right-hand
// sides are the grid's second dimension; past nb = 8, A is read once per
// chunk.
#include <cuda_runtime.h>

#define COL_SENTINEL (1 << 30)
#define MAX_NBC 8     // right-hand sides per thread, in registers
#define LANE_CHUNK 8  // lanes whose columns and values a thread loads at once

template <int NBC>
__global__ void spmv_ell_kernel(const int* __restrict__ cols, const float* __restrict__ vals,
                                const float* __restrict__ x, float* __restrict__ y, int m, int n,
                                int w, int nb) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const int lane0 = blockIdx.y * NBC;  // the chunk's first right-hand side
  const int cnt = min(NBC, nb - lane0);
  const float* xs = x + (size_t)lane0 * n;
  float acc[NBC];
#pragma unroll
  for (int k = 0; k < NBC; ++k) acc[k] = 0.0f;
  for (int q0 = 0; q0 < w; q0 += LANE_CHUNK) {
    // the chunk's columns and values in one go, then its gathers, so that
    // a thread waits for memory twice per chunk and not twice per lane
    int col[LANE_CHUNK];
    float val[LANE_CHUNK];
#pragma unroll
    for (int j = 0; j < LANE_CHUNK; ++j) {
      const bool in = q0 + j < w;
      const int e = row * w + q0 + j;
      col[j] = in ? cols[e] : COL_SENTINEL;
      val[j] = in ? vals[e] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < NBC; ++k) {
      if (k >= cnt) break;
      float xg[LANE_CHUNK];
#pragma unroll
      for (int j = 0; j < LANE_CHUNK; ++j)
        xg[j] = col[j] < COL_SENTINEL ? xs[(size_t)k * n + min(col[j], n - 1)] : 0.0f;
#pragma unroll
      for (int j = 0; j < LANE_CHUNK; ++j)  // ascending lanes; sentinel lanes skipped
        if (col[j] < COL_SENTINEL) acc[k] = __fadd_rn(acc[k], __fmul_rn(val[j], xg[j]));
    }
  }
#pragma unroll
  for (int k = 0; k < NBC; ++k)
    if (k < cnt) y[(size_t)(lane0 + k) * m + row] = acc[k];
}

// NBC = min(nb, MAX_NBC): the fewest registers that hold a chunk.
template <int NBC>
static void spmv_ell_dispatch(const int* cols, const float* vals, const float* x, float* y, int m,
                              int n, int w, int nb, cudaStream_t stream) {
  if constexpr (NBC < MAX_NBC) {
    if (nb > NBC) {
      spmv_ell_dispatch<NBC + 1>(cols, vals, x, y, m, n, w, nb, stream);
      return;
    }
  }
  const int threads = 256;
  const dim3 grid((m + threads - 1) / threads, (nb + NBC - 1) / NBC);
  spmv_ell_kernel<NBC><<<grid, threads, 0, stream>>>(cols, vals, x, y, m, n, w, nb);
}

// The (m, W) arrays hold fewer than 2^31 entries (indexed with int here).
extern "C" int spmv_ell_launch(const void* cols, const void* vals, const void* x, void* y,
                               int m, int n, int w, int nb, void* stream) {
  if ((long long)m * w >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  spmv_ell_dispatch<1>((const int*)cols, (const float*)vals, (const float*)x, (float*)y, m, n, w,
                       nb, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
