// The level body shared by the triangular sweeps (tri_solve_wavefront.cu,
// epoch_sweep.cu): one row's lane-ordered masked sum of rounded products,
// acc = sum over lanes q with cols[q] < limit of vals[q] * x[cols[q]],
// from +0.0, each product rounded by __fmul_rn before the __fadd_rn add
// (masked_lane_sum in the reference). Masked lanes are skipped and never
// gathered: the reference adds +0.0 for them, which leaves an accumulator
// that started at +0.0 unchanged.
#pragma once

__device__ __forceinline__ float level_row_sum(const int* cols, const float* vals,
                                               const float* x, int w, int limit) {
  float acc = 0.0f;
  for (int q = 0; q < w; ++q) {
    int cq = cols[q];
    if (cq < limit) acc = __fadd_rn(acc, __fmul_rn(vals[q], x[cq]));
  }
  return acc;
}
