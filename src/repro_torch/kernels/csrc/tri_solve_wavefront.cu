// Fused L-then-U level-scheduled triangular solve x = (LU)^{-1} b, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `tri_solve_wavefront` in
// src/repro/kernels/tri_solve_wavefront.py, whose body is
// repro.core.triangular.wavefront_sweeps_jnp.
//
// Level-major slots: row r of level l lives at slot l*maxr + r. An L row
// writes x_l[s] = b_ext[rhs_idx[s]] - acc (b_ext[n] = 0); a U row writes
// x_u[s] = (x_l[u_rhs_idx[s]] - acc) / diag[s]; then out[j] = x_u[perm[j]].
// acc is the lane-ordered masked sum of rounded products from +0.0
// (__fmul_rn, __fadd_rn), as masked_lane_sum in the reference; lanes whose
// slot is the scratch slot (n_slots) are skipped, never gathered. The level
// body is level_row_sum (level_row.cuh), shared with epoch_sweep.cu. Every
// slot of a level is written, pad rows included, as the reference's
// dynamic_update_slice does. The wrapper zeroes x_l and x_u, so their
// scratch slots read 0.
//
// Bound: the chain of levels, not bytes. A few MB move, but the L levels
// and then the U levels depend on each other in sequence, so the time is
// the number of levels times one level's latency (dependent loads, a few
// flops, a store, a block barrier). Design: the simplest correct one, one
// block that loops over the levels with __syncthreads() between them; its
// threads stride over the rows of a level (maxr may exceed 1024), and the
// same block then gathers the output. Multi-block levels with a grid
// barrier and shared-memory level tiles are later work. The sweep vectors
// are read with plain loads because the block writes them.
//
// Batched form: one block per right-hand side (grid = nb). Block `lane`
// runs the unchanged level loop on b + lane*n, its own x_l/x_u scratch rows
// (nb, slots+1, zeroed by the wrapper) and out + lane*n. The blocks share
// the read-only factor arrays and nothing else, so a lane's bits do not
// depend on nb; up to 132 lanes run at once on separate SMs, each bound by
// the same chain.
#include <cuda_runtime.h>

#include "level_row.cuh"

__global__ void tri_solve_wavefront_kernel(
    const int* l_cols, const float* l_vals, const int* l_rhs_idx, const int* u_cols,
    const float* u_vals, const float* u_diag, const int* u_rhs_idx, const int* out_perm,
    const float* b, float* x_l, float* x_u, float* out, int n, int nl_lev, int maxr_l,
    int wl, int nu_lev, int maxr_u, int wu) {
  const int nl_slots = nl_lev * maxr_l;
  const int nu_slots = nu_lev * maxr_u;
  const size_t lane = blockIdx.x;
  b += lane * n;
  out += lane * n;
  x_l += lane * (size_t)(nl_slots + 1);
  x_u += lane * (size_t)(nu_slots + 1);
  for (int lev = 0; lev < nl_lev; ++lev) {
    for (int r = threadIdx.x; r < maxr_l; r += blockDim.x) {
      size_t s = (size_t)lev * maxr_l + r;
      float acc = level_row_sum(l_cols + s * wl, l_vals + s * wl, x_l, wl, nl_slots);
      int ri = l_rhs_idx[s];
      float rhs = ri < n ? b[ri] : 0.0f;
      x_l[s] = __fsub_rn(rhs, acc);
    }
    __syncthreads();
  }
  for (int lev = 0; lev < nu_lev; ++lev) {
    for (int r = threadIdx.x; r < maxr_u; r += blockDim.x) {
      size_t s = (size_t)lev * maxr_u + r;
      float acc = level_row_sum(u_cols + s * wu, u_vals + s * wu, x_u, wu, nu_slots);
      float rhs = x_l[u_rhs_idx[s]];
      x_u[s] = __fdiv_rn(__fsub_rn(rhs, acc), u_diag[s]);
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += blockDim.x) out[j] = x_u[out_perm[j]];
}

extern "C" int tri_solve_wavefront_launch(
    const void* l_cols, const void* l_vals, const void* l_rhs_idx, const void* u_cols,
    const void* u_vals, const void* u_diag, const void* u_rhs_idx, const void* out_perm,
    const void* b, void* x_l, void* x_u, void* out, int n, int nl_lev, int maxr_l, int wl,
    int nu_lev, int maxr_u, int wu, int nb, void* stream) {
  int widest = maxr_l > maxr_u ? maxr_l : maxr_u;
  int threads = ((widest + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  tri_solve_wavefront_kernel<<<nb, threads, 0, (cudaStream_t)stream>>>(
      (const int*)l_cols, (const float*)l_vals, (const int*)l_rhs_idx, (const int*)u_cols,
      (const float*)u_vals, (const float*)u_diag, (const int*)u_rhs_idx,
      (const int*)out_perm, (const float*)b, (float*)x_l, (float*)x_u, (float*)out, n,
      nl_lev, maxr_l, wl, nu_lev, maxr_u, wu);
  return (int)cudaGetLastError();
}
