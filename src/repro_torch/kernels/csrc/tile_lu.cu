// In-tile LU without pivoting, for Hopper (sm_90a): the pivot step
// A_II = L_II U_II of Block-ILU(k).
//
// A kernel of the port only: the JAX package computes this step with the
// plain-JAX loop `_lu_nopiv` (src/repro/core/bilu.py:83), not with Pallas.
// In eager PyTorch that loop would cost about six launches per column, bs
// of them per tile and one tile per pivot: about a million launches at
// bs = 128 on poisson_2d(400). Here it is one launch per tile.
//
// Result: the packed tile, strict lower = L (unit diagonal implicit),
// upper = U. For each column c: the entries below the pivot are divided by
// it (__fdiv_rn), then every entry of the trailing block takes away the
// rounded product of its row's multiplier and the pivot row's entry
// (__fsub_rn(t, __fmul_rn(l, u))), the order of the plain version
// `tile_lu_nopiv_ref` in kernels/ref.py, which this kernel equals bitwise.
//
// Bound: one 128 x 128 tile moves 128 KB and does ~1.4 MFLOP, about
// 0.04 us at 3.35 TB/s; the work is a chain of bs dependent column steps,
// each two barriers long. Design: one block per tile; the tile sits in
// shared memory (rows padded to bs + 1 floats, so that a column's entries
// fall in different banks; 66 KB at bs = 128, above the default 48 KB and
// so asked for). 512 threads share each step: all of them the division of
// the column, then 16 rows of the trailing block at a time, a warp along
// each row. The output may be the input tile itself.
#include <cuda_runtime.h>

#define TX 32  // threads along a row of the trailing block
#define TY 16  // rows of the trailing block handled side by side

__global__ void __launch_bounds__(TX * TY)
tile_lu_kernel(const float* t, float* out, int bs) {
  extern __shared__ float st[];  // t[r, c] at r * ld + c
  const int ld = bs + 1, tx = threadIdx.x, ty = threadIdx.y, tid = ty * TX + tx;
  for (int r = ty; r < bs; r += TY)
    for (int c = tx; c < bs; c += TX) st[r * ld + c] = t[(size_t)r * bs + c];
  __syncthreads();
  for (int c = 0; c < bs; ++c) {
    const float piv = st[c * ld + c];
    for (int r = c + 1 + tid; r < bs; r += TX * TY)
      st[r * ld + c] = __fdiv_rn(st[r * ld + c], piv);
    __syncthreads();
    for (int r = c + 1 + ty; r < bs; r += TY) {
      const float l = st[r * ld + c];
      for (int j = c + 1 + tx; j < bs; j += TX)
        st[r * ld + j] = __fsub_rn(st[r * ld + j], __fmul_rn(l, st[c * ld + j]));
    }
    __syncthreads();
  }
  for (int r = ty; r < bs; r += TY)
    for (int c = tx; c < bs; c += TX) out[(size_t)r * bs + c] = st[r * ld + c];
}

extern "C" int tile_lu_launch(const void* t, void* out, int bs, void* stream) {
  const size_t smem = (size_t)bs * (bs + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tile_lu_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  tile_lu_kernel<<<1, dim3(TX, TY), smem, (cudaStream_t)stream>>>((const float*)t, (float*)out,
                                                                  bs);
  return (int)cudaGetLastError();
}
