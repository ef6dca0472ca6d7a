// One collective epoch of the band-partitioned triangular sweep, for Hopper
// (sm_90a), over D band owners and nb right-hand sides at once.
//
// Replaces the Pallas kernel `epoch_sweep` in
// src/repro/kernels/tri_sweep_epoch.py, whose body is
// repro.core.triangular.epoch_sweep_jnp: the compute an owner performs
// between two exchanges of the distributed sweep (the exchanges stay
// outside, in repro_torch.core.top_ilu.BandGroup).
//
// Layout: owner d's sweep vector for right-hand side `lane` is
// x[d][lane][0 .. xlen), laid out [local slots | ingress halo | scratch]
// (xlen = scratch + 1). The level tables cols/vals are (D, nlev, maxr, W)
// with owner-local dependency addresses (padding -> the scratch address
// `limit`), rhs is (D, nb, nlev, maxr) and diag (D, nlev, maxr) or null for
// the unit-diagonal L sweep. The launch runs the epoch's levels [lo, hi):
// row r of level l writes slot l*maxr + r,
//     y = rhs - acc            (L)
//     y = (rhs - acc) / diag   (U, __fdiv_rn)
// with acc the level body shared with tri_solve_wavefront.cu
// (level_row_sum, level_row.cuh): lanes at or past `limit` are skipped
// (such a lane reads the scratch slot `limit` and drops it). Every slot of every level is written, pad rows included,
// as the reference's dynamic_update_slice does (a pad row has all lanes
// masked, so it writes its rhs, divided by the ones-lane 1.0 for U).
//
// Launch shape: one launch per epoch, grid (D, nb); block (d, lane) runs
// the epoch's levels over its own x[d][lane] only, with __syncthreads()
// between levels, its threads striding over the maxr rows of a level. No
// block reads another owner's slice: values cross owners only through the
// exchange between launches. The whole level tables and the level range
// are passed, so an epoch costs one launch and no copies.
//
// Bound: the chain of levels and the launch, not bytes. An epoch of the
// natural ordering holds one or two levels of at most 50 rows per owner, so
// a launch moves a few KB; its time is the launch latency plus one level's
// dependent loads. Design: the simplest correct one, the level loop of
// tri_solve_wavefront.cu per (owner, lane). Fusing epochs (the fusion
// ordering) and a CUDA graph of the apply are later work.
#include <cuda_runtime.h>

#include "level_row.cuh"

__global__ void epoch_sweep_kernel(float* x, const int* cols, const float* vals,
                                   const float* rhs, const float* diag, int nb, int nlev,
                                   int maxr, int w, int xlen, int lo, int hi, int limit) {
  const size_t d = blockIdx.x;
  const size_t lane = blockIdx.y;
  float* xv = x + (d * nb + lane) * (size_t)xlen;
  const size_t tab = d * (size_t)nlev * maxr;  // owner d's first (level, rank) row
  const int* c = cols + tab * w;
  const float* v = vals + tab * w;
  const float* r = rhs + (d * nb + lane) * (size_t)nlev * maxr;
  const float* g = diag == nullptr ? nullptr : diag + tab;
  for (int lev = lo; lev < hi; ++lev) {
    for (int i = threadIdx.x; i < maxr; i += blockDim.x) {
      size_t s = (size_t)lev * maxr + i;
      float acc = level_row_sum(c + s * w, v + s * w, xv, w, limit, limit);
      float y = __fsub_rn(r[s], acc);
      if (g != nullptr) y = __fdiv_rn(y, g[s]);
      xv[s] = y;
    }
    __syncthreads();
  }
}

extern "C" int epoch_sweep_launch(void* x, const void* cols, const void* vals, const void* rhs,
                                  const void* diag, int n_owners, int nb, int nlev, int maxr,
                                  int w, int xlen, int lo, int hi, int limit, void* stream) {
  int threads = ((maxr + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  dim3 grid(n_owners, nb);
  epoch_sweep_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (float*)x, (const int*)cols, (const float*)vals, (const float*)rhs, (const float*)diag,
      nb, nlev, maxr, w, xlen, lo, hi, limit);
  return (int)cudaGetLastError();
}
