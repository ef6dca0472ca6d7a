// One superstep of the band-superstep (TOP-ILU) factorization, for Hopper
// (sm_90a), over D band owners at once.
//
// Port-only: the JAX package has no Pallas kernel here. It runs the
// superstep body of repro.core.numeric_jax.make_superstep_factorizer as
// plain JAX, which XLA compiles into one program; a plain PyTorch version
// would be a Python loop of about 2M small launches at poisson_2d(400).
//
// Layout: owner d's value state is state[d][0 .. srows) x W, laid out
// [local rows | halo | scratch] (srows = s_loc + H + 1); piv_addr,
// piv_dlane (D, s_loc, MP), piv_dst (D, s_loc, MP, W) and n_piv (D, s_loc)
// are owner-local per-row tables, sched (n_sup, D, MPD) the superstep
// schedule (band ids, n_bands-padded).
//
// Launch shape: one launch per superstep s, grid (D, MPD); block (d, g)
// factors band b = sched[s][d][g] of owner d (local rows (b/D)*R ..
// +R) with the band's R x W values in shared memory, then writes them back.
// Padded bands (b >= n_bands) return at once: the reference writes their
// garbage into the scratch row, which several padded bands of one launch
// would race on, and the scratch bits feed only dropped lanes.
//
// Arithmetic, per row in order and per pivot p < n_piv in ascending order
// (pivots p >= n_piv are skipped; the reference's are no-ops):
//     piv = pivot row [piv_dlane]      (in-band rows from the buffer,
//                                       finished rows from state via piv_addr)
//     l   = __fdiv_rn(x[p], piv)
//     x[dst] = __fsub_rn(x[dst], __fmul_rn(l, pivot row[w]))  for piv_dst[w] < W
//     x[p] = l
// the oracle's divide, product rounded before the subtract, ascending
// pivots: the bits of numeric_ilu_ref. The destination lanes of one pivot
// are distinct, so the threads of the block (striding over W) update them
// in parallel; two barriers per pivot order the reads of x[p] before its
// store and the updates before the next pivot.
//
// Bound: the chain, not bytes. A band's 32 rows and their pivots (<= 3 for
// ILU(1) of a 5-point stencil) are a dependent sequence of a divide, a
// few rounded updates and two barriers each; a superstep's time is that
// chain plus the launch. Bands of one superstep run as separate blocks.
// Only rows finished in earlier supersteps are read from state (a band
// waits on every band it pulls from), so the blocks never race.
//
// Wide bands: a band of R x W floats above the shared memory a block may
// take (W is the widest factor row, which one dense row makes n) is
// factored in place in `state` by the IN_SMEM = false variant of the same
// body: the band's rows are read and written where they lie, so an
// in-band pivot row is read from the same address either way. The pivot
// order and every rounded operation are unchanged, so the bits are too;
// the block's barriers also order its global reads and writes. The
// wrapper picks the variant by size.
#include <cuda_runtime.h>

template <bool IN_SMEM>
__global__ void superstep_factor_kernel(float* state, const int* sched, const int* piv_addr,
                                        const int* piv_dlane, const int* piv_dst,
                                        const int* n_piv, int s, int mpd, int srows, int s_loc,
                                        int R, int W, int MP, int n_bands) {
  extern __shared__ float buf[];  // R x W (IN_SMEM only)
  const int n_owners = gridDim.x;
  const int d = blockIdx.x;
  const int b = sched[((size_t)s * n_owners + d) * mpd + blockIdx.y];
  if (b >= n_bands) return;  // the whole block: before any barrier
  const int base = (b / n_owners) * R;
  float* st = state + (size_t)d * srows * W;
  const size_t row0 = (size_t)d * s_loc;  // owner d's first row in the per-row tables
  float* band = IN_SMEM ? buf : st + (size_t)base * W;
  if (IN_SMEM) {
    for (int i = threadIdx.x; i < R * W; i += blockDim.x) buf[i] = st[(size_t)base * W + i];
    __syncthreads();
  }
  for (int r = 0; r < R; ++r) {
    const size_t jl = row0 + base + r;
    float* x = band + (size_t)r * W;
    const int np = n_piv[jl];
    for (int p = 0; p < np; ++p) {
      const int addr = piv_addr[jl * MP + p];
      const int li = addr - base;
      const float* pv = (li >= 0 && li < R) ? band + (size_t)li * W : st + (size_t)addr * W;
      const float l = __fdiv_rn(x[p], pv[piv_dlane[jl * MP + p]]);
      __syncthreads();  // every thread has read x[p]
      const int* dst = piv_dst + (jl * MP + p) * W;
      for (int w = threadIdx.x; w < W; w += blockDim.x) {
        int dw = dst[w];
        if (dw < W) x[dw] = __fsub_rn(x[dw], __fmul_rn(l, pv[w]));
      }
      if (threadIdx.x == 0) x[p] = l;
      __syncthreads();  // the row is complete for the next pivot
    }
  }
  if (IN_SMEM) {
    for (int i = threadIdx.x; i < R * W; i += blockDim.x) st[(size_t)base * W + i] = buf[i];
  }
}

// in_smem: 1 when the R x W band fits in the shared memory of one block
// (the wrapper decides), else 0 and the band is factored in place.
extern "C" int superstep_factor_launch(void* state, const void* sched, const void* piv_addr,
                                       const void* piv_dlane, const void* piv_dst,
                                       const void* n_piv, int s, int n_owners, int mpd,
                                       int srows, int s_loc, int R, int W, int MP, int n_bands,
                                       int in_smem, void* stream) {
  const dim3 grid(n_owners, mpd);
  if (!in_smem) {
    superstep_factor_kernel<false><<<grid, 32, 0, (cudaStream_t)stream>>>(
        (float*)state, (const int*)sched, (const int*)piv_addr, (const int*)piv_dlane,
        (const int*)piv_dst, (const int*)n_piv, s, mpd, srows, s_loc, R, W, MP, n_bands);
    return (int)cudaGetLastError();
  }
  size_t smem = (size_t)R * W * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(superstep_factor_kernel<true>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  superstep_factor_kernel<true><<<grid, 32, smem, (cudaStream_t)stream>>>(
      (float*)state, (const int*)sched, (const int*)piv_addr, (const int*)piv_dlane,
      (const int*)piv_dst, (const int*)n_piv, s, mpd, srows, s_loc, R, W, MP, n_bands);
  return (int)cudaGetLastError();
}
