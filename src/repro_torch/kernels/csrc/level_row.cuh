// The level body shared by the triangular sweeps (tri_solve_wavefront.cu,
// epoch_sweep.cu): one row's lane-ordered masked sum of rounded products,
// acc = sum over lanes q with cols[q] < limit of vals[q] * x[cols[q]],
// from +0.0, each product rounded by __fmul_rn before the __fadd_rn add
// (masked_lane_sum in the reference). Masked lanes are skipped: the
// reference adds +0.0 for them, which leaves an accumulator that started
// at +0.0 unchanged (and adding +0.0 to -0.0 would not).
//
// Lanes go in chunks of ROW_CHUNK: the chunk's columns and values are
// loaded together, then its gathers, then its products are added in
// ascending lane order, so a row waits for memory twice per chunk and not
// twice per lane, and the code has no branch. A masked lane gathers slot
// `safe` (any slot that may be read) and its product is dropped. `x` is
// anything indexable by a slot: the sweep vector itself (epoch_sweep.cu),
// or a view that reads recent levels from shared memory and older ones
// from device memory (tri_solve_wavefront.cu); where a value comes from
// never changes it.
#pragma once

#define ROW_CHUNK 4

template <typename X>
__device__ __forceinline__ float level_row_sum(const int* cols, const float* vals, const X& x,
                                               int w, int limit, int safe) {
  float acc = 0.0f;
  for (int q0 = 0; q0 < w; q0 += ROW_CHUNK) {
    int c[ROW_CHUNK];
    float v[ROW_CHUNK], g[ROW_CHUNK];
#pragma unroll
    for (int j = 0; j < ROW_CHUNK; ++j) {
      const bool in = q0 + j < w;
      c[j] = in ? cols[q0 + j] : limit;
      v[j] = in ? vals[q0 + j] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < ROW_CHUNK; ++j) g[j] = x[c[j] < limit ? c[j] : safe];
#pragma unroll
    for (int j = 0; j < ROW_CHUNK; ++j) {
      const float sum = __fadd_rn(acc, __fmul_rn(v[j], g[j]));
      acc = c[j] < limit ? sum : acc;
    }
  }
  return acc;
}
