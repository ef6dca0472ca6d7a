// Round-major pivot-op ILU(k) numeric factorization, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `factor_wavefront` in
// src/repro/kernels/panel_update.py, whose body is
// repro.core.numeric_jax.factor_wavefront_sweeps_jnp.
//
// Per op t of a round (reduce row j against pivot row i at lane p):
//   l = x[j,p] / x[i,dlane];  x[j,dst[t,q]] -= rn(l * x[i,q]);  x[j,p] = l
// with __fdiv_rn, __fmul_rn and __fsub_rn, in the reference's order. Lane
// dst == W is dropped and skipped. Pad ops (row == n) are skipped: in the
// reference they only rewrite the zero scratch row with itself.
//
// Why it may update in place: the ops of one round reduce distinct rows,
// and every pivot row they read finished in an earlier round (the schedule
// makes op (j,p) wait on the last op of its pivot row). So within a round no
// thread writes a row that another thread reads.
//
// Bound: the chain of rounds, not bytes. The work is a few MB, but the
// NR rounds depend on each other, so the time is NR times one round's
// latency: a dependent chain of global loads (schedule, then rows), a few
// flops, a store, and a block barrier. Design: the simplest correct one,
// a single block that loops over the rounds with __syncthreads() between
// them; its threads stride over the ops of a round, one op per thread, and
// walk the W lanes in order. The values stay in global memory (they fit in
// L2). One launch per round (NR launches) was the alternative; a persistent
// multi-block kernel with a grid barrier, or shared-memory staging of the
// round's schedule, is later work. The values are read with plain loads
// (no __restrict__, no read-only cache) because the block writes them.
#include <cuda_runtime.h>

__global__ void factor_wavefront_kernel(const int* op_row, const int* op_lane,
                                        const int* op_piv, const int* op_dlane,
                                        const int* op_dst, const int* dst_flat, float* x,
                                        int n_rounds, int max_ops, int n, int w) {
  for (int r = 0; r < n_rounds; ++r) {
    for (int t = threadIdx.x; t < max_ops; t += blockDim.x) {
      size_t o = (size_t)r * max_ops + t;
      int j = op_row[o];
      if (j >= n) continue;  // pad op
      int p = op_lane[o];
      int i = op_piv[o];
      int dl = op_dlane[o];
      const int* dst = dst_flat + (size_t)op_dst[o] * w;
      float* xj = x + (size_t)j * w;
      const float* xi = x + (size_t)i * w;
      float l = __fdiv_rn(xj[p], xi[dl]);
      for (int q = 0; q < w; ++q) {
        int d = dst[q];
        if (d < w) xj[d] = __fsub_rn(xj[d], __fmul_rn(l, xi[q]));
      }
      xj[p] = l;
    }
    __syncthreads();
  }
}

extern "C" int factor_wavefront_launch(const void* op_row, const void* op_lane,
                                       const void* op_piv, const void* op_dlane,
                                       const void* op_dst, const void* dst_flat, void* x,
                                       int n_rounds, int max_ops, int n, int w,
                                       void* stream) {
  int threads = ((max_ops + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  factor_wavefront_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(
      (const int*)op_row, (const int*)op_lane, (const int*)op_piv, (const int*)op_dlane,
      (const int*)op_dst, (const int*)dst_flat, (float*)x, n_rounds, max_ops, n, w);
  return (int)cudaGetLastError();
}
