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
// started at +0.0. The build passes -fmad=false as a second guard.
//
// Bound: bytes. Each row reads W column indices, W values and W gathered x
// entries and writes one float, about 8 bytes per stored entry plus the
// vectors, against 2 flops per entry. Design: one thread per row, so that a
// warp streams 32 consecutive rows; x (640 KB at the main size) stays in L2
// for the gathers. Rows are stored row-major, so a warp's lane-q loads are
// strided by W; a column-major copy of the ELL arrays would coalesce them
// and is later work. A batch of nb right-hand sides is the grid's second
// dimension: lane blockIdx.y reads x + lane*n and writes y + lane*m with
// the same per-row loop, so a row's bits do not depend on nb. The m rows
// may be a row block of a larger matrix (m != n): the distributed path's
// owners each reduce their own block against the whole x.
#include <cuda_runtime.h>

#define COL_SENTINEL (1 << 30)

__global__ void spmv_ell_kernel(const int* cols, const float* vals, const float* x,
                                float* y, int m, int n, int w) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const size_t lane = blockIdx.y;
  x += lane * n;
  y += lane * m;
  const int* c = cols + (size_t)row * w;
  const float* v = vals + (size_t)row * w;
  float acc = 0.0f;
  for (int q = 0; q < w; ++q) {
    int col = c[q];
    if (col < COL_SENTINEL) {
      // clamp like the Pallas kernel: a valid column is < n
      acc = __fadd_rn(acc, __fmul_rn(v[q], x[min(col, n - 1)]));
    }
  }
  y[row] = acc;
}

extern "C" int spmv_ell_launch(const void* cols, const void* vals, const void* x, void* y,
                               int m, int n, int w, int nb, void* stream) {
  const int threads = 256;
  const dim3 grid((m + threads - 1) / threads, nb);
  spmv_ell_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)cols, (const float*)vals, (const float*)x, (float*)y, m, n, w);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
