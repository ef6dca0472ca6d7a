// The two dense-tile triangular solves of Block-ILU(k), for Hopper (sm_90a).
//
// Replaces the Pallas kernels `trsm_right_upper` and `trsm_left_unit_lower`
// in src/repro/kernels/tri_solve.py:
//
// * trsm_right_upper:  X U = A for A (M, bs), U (bs, bs) upper: the L-panel
//   step L_JI = A_JI U_II^{-1}. Rows of X are independent; each is
//       x[r, c] = (a[r, c] - sum_{j<c} x[r, j] u[j, c]) / u[c, c].
// * trsm_left_unit_lower:  L X = A for L (bs, bs) unit-lower, A (bs, N): the
//   U-panel step U_IJ = L_II^{-1} A_IJ. Columns are independent; each is
//       x[r, c] = a[r, c] - sum_{j<r} l[r, j] x[j, c].
//
// Arithmetic: every sum runs in ascending j from +0.0, one __fmul_rn product
// rounded before each __fadd_rn add, then __fsub_rn and (right solve)
// __fdiv_rn: the order of the plain versions in kernels/ref.py, which these
// kernels equal bitwise. The substitution is right-looking: once x[j] is
// final it is broadcast and every later accumulator adds its product, so
// each accumulator still receives its terms for j = 0, 1, ... in ascending
// order, as the left-looking dot product of the plain version adds them.
// Only the triangle a solve needs is read: entries of U below its diagonal,
// and of L on and above it, never are, so the packed LU tile of the pivot
// is passed as it is (the Pallas kernel masks them the same way,
// tri_solve.py:33,48).
//
// Bound: one (128, 128) solve moves 192 KB (a, the triangle, x), about
// 0.06 us at 3.35 TB/s, and does ~2 MFLOP, so neither bytes nor operations
// bound it: the chain of bs dependent steps of one row (right) or column
// (left) does. Step j of the right solve is a subtract, a divide, a warp
// broadcast, then a product and an add into the next accumulator; the left
// solve has no divide. Design: one warp per row (right) or column (left)
// of X, lane l holding the accumulators and x of the columns (rows)
// congruent to l mod 32 in registers, so the up-to-bs-1 updates of a step
// run side by side on 32 lanes and the chain is bs steps long. At step j
// the owner's subtract is broadcast and every lane computes x[j] from it
// (right: the same divide on every lane), so no branch on the chain
// diverges. The
// triangle of one block sits in shared memory, copied once with cp.async
// (only its own entries): U row-major, read along a row (32 lanes, 32
// banks); L with an odd row stride (bs | 1) because the lanes read a
// column. Rows of the right solve's A are contiguous and read coalesced
// straight into registers; the left solve's columns are strided, so the
// block's 8 columns are staged through shared memory, row by row.
//
// Large tiles: a triangle too large for the shared memory of one block
// (bs above 241 right, 236 left on the H100) is read in place from device
// memory by the TRI_IN_SMEM = false variant of the same body (a 256 x 256
// tile is 256 KB, which stays in L2). Only where the triangle is read
// from changes: the chain, its order of rounded operations and so the
// bits are the same. The left solve still stages its columns in shared
// memory. The launch picks the variant from the device's limit: NC <= 7
// (bs <= 224) always fits and NC >= 9 (bs > 256) never does, so the
// in-place variant is instantiated for NC >= 8 and the other for NC <= 8.
// Registers bound the tile: NC <= 16 accumulators per lane, bs <= 512.
//
// One kernel body serves one panel and a batch of tiles: blockIdx.y picks
// the panel, at `slots[blockIdx.y]` tiles of the pool (the batched form:
// all of one pivot's tiles in one launch, in place) or at the panel itself
// when `slots` is null. The output may be the input panel (each warp reads
// its row or its block's columns before it writes them); it must not
// overlap the triangle (the wrapper checks the single form). A batched
// launch checks its slot list on the device, in O(1) per block and off the
// chain: every slot must lie in [0, n_tiles), differ from the diagonal slot
// and exceed the slot listed before it (so the list is distinct). A block
// whose slot breaks that traps before it reads or writes a tile, so a bad
// list ends in a launch error (reported at the next synchronization), never
// in a write past the pool or a race with the triangle.
#include "tile_common.cuh"

#define MAX_NC 16     // accumulators per lane: bs <= 512
#define SMEM_NC 8     // the largest NC whose triangle can fit in shared memory (bs <= 241)
#define ROW_WARPS 8   // right solve: rows of X per block
#define COL_WARPS 8   // left solve: columns of X per block
#define XSTRIDE (COL_WARPS + 1)  // left solve: staged x[r, w] at r * XSTRIDE + w

__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The panel of block row blockIdx.y: the single form's own panel (slots
// null), else the listed tile, checked as the note above says.
__device__ __forceinline__ size_t panel_of(const int* __restrict__ slots, int n_tiles,
                                           int diag_slot) {
  if (!slots) return blockIdx.y;
  const int s = slots[blockIdx.y];
  if (s < 0 || s >= n_tiles || s == diag_slot || (blockIdx.y > 0 && slots[blockIdx.y - 1] >= s))
    __trap();
  return (size_t)s;
}

// NC = ceil(bs / 32): lane `lane` owns columns (right) or rows (left)
// q * 32 + lane, q < NC. The q loops unroll, so x[] and acc[] stay in
// registers.
template <int NC, bool TRI_IN_SMEM>
__global__ void __launch_bounds__(ROW_WARPS * LANES)
trsm_right_upper_kernel(const float* a, const float* __restrict__ u, float* out,
                        const int* __restrict__ slots, int n_tiles, int diag_slot, int m,
                        int bs) {
  extern __shared__ float smem[];
  const float* su = TRI_IN_SMEM ? smem : u;  // u[j, c] at j * bs + c, c >= j
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int r = blockIdx.x * ROW_WARPS + warp;
  const size_t row = (panel_of(slots, n_tiles, diag_slot) * m + r) * bs;
  if (TRI_IN_SMEM) {
    for (int j = warp; j < bs; j += ROW_WARPS)
      for (int c = j + lane; c < bs; c += LANES)
        copy_async(smem + j * bs + c, u + (size_t)j * bs + c);
  }
  float x[NC], acc[NC];
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = q * LANES + lane;
    x[q] = (r < m && c < bs) ? a[row + c] : 0.0f;
    acc[q] = 0.0f;
  }
  wait_async();
  __syncthreads();
  if (r >= m) return;
#pragma unroll
  for (int q0 = 0; q0 < NC; ++q0) {
    const int steps = min(LANES, bs - q0 * LANES);
#pragma unroll 4
    for (int jj = 0; jj < steps; ++jj) {
      const int j = q0 * LANES + jj;
      const float num = __shfl_sync(FULL_MASK, __fsub_rn(x[q0], acc[q0]), jj);
      const float xj = divide(num, su[j * bs + j]);
      x[q0] = lane == jj ? xj : x[q0];
#pragma unroll
      for (int q = q0; q < NC; ++q) {
        const int c = q * LANES + lane;
        if (c > j && c < bs) acc[q] = __fadd_rn(acc[q], __fmul_rn(xj, su[j * bs + c]));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int c = q * LANES + lane;
    if (c < bs) out[row + c] = x[q];
  }
}

template <int NC, bool TRI_IN_SMEM>
__global__ void __launch_bounds__(COL_WARPS * LANES)
trsm_left_unit_lower_kernel(const float* __restrict__ l, const float* a, float* out,
                            const int* __restrict__ slots, int n_tiles, int diag_slot,
                            int bs, int n) {
  extern __shared__ float smem[];
  // odd in shared memory: the 32 rows of a column fall in 32 banks
  const int ld = TRI_IN_SMEM ? (bs | 1) : bs;
  const float* sl = TRI_IN_SMEM ? smem : l;            // l[r, j] at r * ld + j, j < r
  float* sx = smem + (TRI_IN_SMEM ? bs * ld : 0);     // x[r, c0 + w] at r * XSTRIDE + w
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int c0 = blockIdx.x * COL_WARPS, live = min(COL_WARPS, n - c0);
  const size_t panel = panel_of(slots, n_tiles, diag_slot) * bs * n;
  if (TRI_IN_SMEM) {
    for (int r = warp + 1; r < bs; r += COL_WARPS)
      for (int j = lane; j < r; j += LANES)
        copy_async(smem + r * ld + j, l + (size_t)r * bs + j);
  }
  for (int e = threadIdx.x; e < bs * COL_WARPS; e += COL_WARPS * LANES) {
    const int r = e / COL_WARPS, w = e % COL_WARPS;  // consecutive threads, consecutive columns
    if (w < live) sx[r * XSTRIDE + w] = a[panel + (size_t)r * n + c0 + w];
  }
  wait_async();
  __syncthreads();
  if (warp < live) {
    float x[NC], acc[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int r = q * LANES + lane;
      x[q] = r < bs ? sx[r * XSTRIDE + warp] : 0.0f;
      acc[q] = 0.0f;
    }
#pragma unroll
    for (int q0 = 0; q0 < NC; ++q0) {
      const int steps = min(LANES, bs - q0 * LANES);
#pragma unroll 4
      for (int jj = 0; jj < steps; ++jj) {
        const int j = q0 * LANES + jj;
        const float v = __fsub_rn(x[q0], acc[q0]);
        const float xj = __shfl_sync(FULL_MASK, v, jj);
        x[q0] = lane == jj ? v : x[q0];
#pragma unroll
        for (int q = q0; q < NC; ++q) {
          const int r = q * LANES + lane;
          if (r > j && r < bs) acc[q] = __fadd_rn(acc[q], __fmul_rn(sl[r * ld + j], xj));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int r = q * LANES + lane;
      if (r < bs) sx[r * XSTRIDE + warp] = x[q];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < bs * COL_WARPS; e += COL_WARPS * LANES) {
    const int r = e / COL_WARPS, w = e % COL_WARPS;
    if (w < live) out[panel + (size_t)r * n + c0 + w] = sx[r * XSTRIDE + w];
  }
}

// Shared memory above 48 KB must be asked for per kernel (bs >= 106 here).
template <typename K>
static cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Dynamic shared memory of one block with the triangle in it: U (right),
// L at the odd stride and the staged columns (left). Without it the left
// solve keeps only the staged columns.
static size_t right_smem(int bs) { return (size_t)bs * bs * sizeof(float); }
static size_t left_smem(int bs) {
  return ((size_t)bs * (bs | 1) + (size_t)bs * XSTRIDE) * sizeof(float);
}
static size_t left_cols_smem(int bs) { return (size_t)bs * XSTRIDE * sizeof(float); }

// Whether `bytes` of shared memory fit one block of the current device.
static cudaError_t fits_block(size_t bytes, bool* fits) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *fits = err == cudaSuccess && bytes <= (size_t)optin;
  return err;
}

// The smallest NC with NC * 32 >= bs; the triangle in shared memory when
// it fits, else (NC >= SMEM_NC only) read in place.
template <int NC>
static cudaError_t right_launch(const float* a, const float* u, float* out, const int* slots,
                                int n_tiles, int diag_slot, int n_panels, int m, int bs,
                                cudaStream_t stream) {
  if constexpr (NC < MAX_NC) {
    if (NC * LANES < bs)
      return right_launch<NC + 1>(a, u, out, slots, n_tiles, diag_slot, n_panels, m, bs, stream);
  }
  const dim3 grid((m + ROW_WARPS - 1) / ROW_WARPS, n_panels);
  bool fits = true;  // NC < SMEM_NC always fits on sm_90
  cudaError_t err = cudaSuccess;
  if constexpr (NC >= SMEM_NC) {
    err = fits_block(right_smem(bs), &fits);
    if (err != cudaSuccess) return err;
  }
  if constexpr (NC <= SMEM_NC) {
    if (fits) {
      const size_t smem = right_smem(bs);
      err = allow_smem(trsm_right_upper_kernel<NC, true>, smem);
      if (err != cudaSuccess) return err;
      trsm_right_upper_kernel<NC, true><<<grid, ROW_WARPS * LANES, smem, stream>>>(
          a, u, out, slots, n_tiles, diag_slot, m, bs);
      return cudaGetLastError();
    }
  }
  if constexpr (NC >= SMEM_NC) {
    trsm_right_upper_kernel<NC, false><<<grid, ROW_WARPS * LANES, 0, stream>>>(
        a, u, out, slots, n_tiles, diag_slot, m, bs);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

template <int NC>
static cudaError_t left_launch(const float* l, const float* a, float* out, const int* slots,
                               int n_tiles, int diag_slot, int n_panels, int bs, int n,
                               cudaStream_t stream) {
  if constexpr (NC < MAX_NC) {
    if (NC * LANES < bs)
      return left_launch<NC + 1>(l, a, out, slots, n_tiles, diag_slot, n_panels, bs, n, stream);
  }
  const dim3 grid((n + COL_WARPS - 1) / COL_WARPS, n_panels);
  bool fits = true;  // NC < SMEM_NC always fits on sm_90
  cudaError_t err = cudaSuccess;
  if constexpr (NC >= SMEM_NC) {
    err = fits_block(left_smem(bs), &fits);
    if (err != cudaSuccess) return err;
  }
  if constexpr (NC <= SMEM_NC) {
    if (fits) {
      const size_t smem = left_smem(bs);
      err = allow_smem(trsm_left_unit_lower_kernel<NC, true>, smem);
      if (err != cudaSuccess) return err;
      trsm_left_unit_lower_kernel<NC, true><<<grid, COL_WARPS * LANES, smem, stream>>>(
          l, a, out, slots, n_tiles, diag_slot, bs, n);
      return cudaGetLastError();
    }
  }
  if constexpr (NC >= SMEM_NC) {
    const size_t smem = left_cols_smem(bs);
    trsm_left_unit_lower_kernel<NC, false><<<grid, COL_WARPS * LANES, smem, stream>>>(
        l, a, out, slots, n_tiles, diag_slot, bs, n);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// `slots` null: one panel (A at `a`, X at `out`). Otherwise `n_panels`
// tiles of the pool of `n_tiles` at `a` == `out`, tile s at s * m * bs
// floats, none of them `diag_slot` (whose upper triangle `u` is).
extern "C" int trsm_right_upper_launch(const void* a, const void* u, void* out, const void* slots,
                                       int n_tiles, int diag_slot, int n_panels, int m, int bs,
                                       void* stream) {
  if (bs < 1 || bs > MAX_NC * LANES) return (int)cudaErrorInvalidValue;
  return (int)right_launch<1>((const float*)a, (const float*)u, (float*)out, (const int*)slots,
                              n_tiles, diag_slot, n_panels, m, bs, (cudaStream_t)stream);
}

// `slots` null: one panel (A at `a`, X at `out`). Otherwise `n_panels`
// tiles of the pool of `n_tiles` at `a` == `out`, tile s at s * bs * n
// floats, none of them `diag_slot` (whose strict lower triangle `l` is).
extern "C" int trsm_left_unit_lower_launch(const void* l, const void* a, void* out,
                                           const void* slots, int n_tiles, int diag_slot,
                                           int n_panels, int bs, int n, void* stream) {
  if (bs < 1 || bs > MAX_NC * LANES) return (int)cudaErrorInvalidValue;
  return (int)left_launch<1>((const float*)l, (const float*)a, (float*)out, (const int*)slots,
                             n_tiles, diag_slot, n_panels, bs, n, (cudaStream_t)stream);
}
