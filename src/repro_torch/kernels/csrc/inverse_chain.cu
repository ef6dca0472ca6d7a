// Incomplete-inverse preconditioner apply x = Z (W b), for Hopper (sm_90a).
//
// Replaces the Pallas kernel `inverse_chain` in
// src/repro/kernels/inverse_chain.py, whose body is
// repro.core.inverse.inverse_chain_jnp: two sentinel-padded ELL products,
// y = W b and then x = Z y.
//
// Arithmetic: per row, lane-ordered accumulation from +0.0, one __fmul_rn
// product rounded before each __fadd_rn add, as masked_lane_sum in the
// reference. Lanes with col >= COL_SENTINEL are skipped, never gathered
// (the reference adds +0.0 there, which cannot change an accumulator that
// started at +0.0); the other lanes gather min(col, n-1), as the reference
// does. The build passes -fmad=false as a second guard.
//
// What differs from the TPU: the Pallas kernel is one block and keeps all
// of y in VMEM between the two products. Here every row of x needs
// arbitrary rows of y, so the two products need a grid-wide barrier. The
// simple design: one kernel with a `phase` argument, launched twice on the
// same stream (the stream orders phase 1 after phase 0). y lives in an
// (nb, n) scratch buffer the wrapper allocates: 640 KB a right-hand side
// at n = 160,000, so it stays in the 50 MB L2 between the two launches.
// That L2 round trip is what the TPU kernel avoids with VMEM. A
// cooperative single launch with a grid sync is later work.
//
// Bound: bytes. Each phase streams one (n, W) cols/vals pair and gathers
// from a vector that sits in L2, about 8 bytes per stored entry against
// 2 flops. Grid (ceil(n/256), nb): one thread per (row, right-hand side),
// so a warp streams 32 consecutive rows, and a row's bits do not depend on
// nb. Rows are row-major, so a warp's lane-q loads are strided by W, as in
// spmv_ell.cu.
#include <cuda_runtime.h>

#define COL_SENTINEL (1 << 30)

// One phase of the chain: phase 0 computes y = W b, phase 1 x = Z y.
__global__ void inverse_chain_kernel(const int* w_cols, const float* w_vals,
                                     const int* z_cols, const float* z_vals, const float* b,
                                     float* y, float* x, int n, int wi, int zi, int phase) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const size_t lane = blockIdx.y;
  const int w = phase == 0 ? wi : zi;
  const int* c = (phase == 0 ? w_cols : z_cols) + (size_t)row * w;
  const float* v = (phase == 0 ? w_vals : z_vals) + (size_t)row * w;
  const float* in = (phase == 0 ? b : y) + lane * n;
  float* out = (phase == 0 ? y : x) + lane * n;
  float acc = 0.0f;
  for (int q = 0; q < w; ++q) {
    int col = c[q];
    if (col < COL_SENTINEL) acc = __fadd_rn(acc, __fmul_rn(v[q], in[min(col, n - 1)]));
  }
  out[row] = acc;
}

extern "C" int inverse_chain_launch(const void* w_cols, const void* w_vals, const void* z_cols,
                                    const void* z_vals, const void* b, void* y, void* x, int n,
                                    int wi, int zi, int nb, void* stream) {
  const int threads = 256;
  const dim3 grid((n + threads - 1) / threads, nb);
  cudaStream_t s = (cudaStream_t)stream;
  // the stream orders phase 1 after phase 0: the barrier between the products
  for (int phase = 0; phase < 2; ++phase) {
    inverse_chain_kernel<<<grid, threads, 0, s>>>(
        (const int*)w_cols, (const float*)w_vals, (const int*)z_cols, (const float*)z_vals,
        (const float*)b, (float*)y, (float*)x, n, wi, zi, phase);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
