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
// upper = U. The elimination runs in its row (IKJ) form: row r takes, for
// c = 0, 1, ..., r - 1 in turn,
//     l = t[r][c] / u[c][c]                      (__fdiv_rn)
//     t[r][j] = t[r][j] - l * u[c][j], j > c     (__fmul_rn, then __fsub_rn)
// where u[c] is row c once final. Every entry so receives exactly the
// rounded operations of the column (KIJ) loop of the plain version
// `tile_lu_nopiv_ref` in kernels/ref.py, in the same order, and equals it
// bitwise: at column step c the plain version updates row r with row c as
// it stands after steps 0..c-1, which is row c final from column c on.
//
// Bound: one 128 x 128 tile moves 128 KB and does ~1.4 MFLOP, about
// 0.04 us at 3.35 TB/s; what bounds it is the chain: row r is final only
// after row r - 1 is, so the tile is a chain of bs dependent row steps.
// Design: one block per tile, one warp per row, rows dealt round-robin to
// the block's 32 warps; lane l holds the row's entries of the columns
// congruent to l mod 32 in registers (NC = ceil(bs / 32) of them). A step
// loads row c's entries of the lane's columns, takes the pivot from lane
// c mod 32 and t[r][c] from the row's owner lane by warp broadcasts, does
// one divide (the same on every lane, so no branch diverges) and the
// row's update. A final row is published (into shared memory, or into the
// output) and each lane raises its own count of final rows with a release
// store; a lane waits for row c only when its last reading of its count
// is not above c, with an acquire load. A lane so synchronizes only with
// the lanes that wrote the columns it reads (lane l of every warp owns the
// columns congruent to l), and no block-wide barrier lies on the chain.
// Rows finish in order (row r's last step waits for row r - 1), so one
// count per lane serves as every row's ready flag.
//
// Large tiles: a tile too large for the shared memory of one block (bs
// above 240 on the H100) publishes its final rows into the output, and the
// IN_SMEM = false variant of the same body reads them there (L2-resident:
// 256 KB at bs = 256). Only where the final rows are read from changes:
// the chain, its rounded operations and so the bits are the same. The
// shared-memory variant writes the output once, after the last row. The
// launch picks the variant from the device's limit.
//
// Tiles above bs = 512 (more than 16 entries of a row per lane): the
// CHUNKED variant walks each row in chunks of 16 x 32 = 512 columns. For
// chunk [cb, cb + 512) the row first takes the steps c < min(r, cb), in
// ascending c, with l = t[r][c] read back from the row's earlier chunk in
// the output (written by the same warp, ordered by __syncwarp); then the
// steps c in [cb, min(r, cb + 512)) as the bs <= 512 body runs them. A step
// c only touches columns j > c, so chunk cb's entries are final after the
// steps c < cb + 512, and each entry still receives its steps in ascending
// c, the rounded operations of the plain version: the bits are the same.
// Each chunk has its own counts of final rows (see the kernel); the final
// rows are read from the output (IN_SMEM = false).
#include "tile_common.cuh"

#define WARPS 32
#define MAX_NC 16  // registers per lane for one row: bs <= 512 in one chunk
#define CHUNK (MAX_NC * LANES)  // columns of one chunk of the CHUNKED variant
#define SMEM_NC 8  // the largest NC whose tile can fit in shared memory (bs <= 240)
#define HEAD LANES // floats before the tile in shared memory: the lanes' counts

template <int NC, bool IN_SMEM>
__global__ void __launch_bounds__(WARPS * LANES)
tile_lu_kernel(const float* t, float* out, int bs) {
  extern __shared__ __align__(16) float smem[];
  int* done = reinterpret_cast<int*>(smem) + threadIdx.x % LANES;  // this lane's count
  float* u = IN_SMEM ? smem + HEAD : out;  // final row c at u + c * bs
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  if (threadIdx.x < LANES) *done = 0;
  __syncthreads();
  int known = 0;  // this lane's last reading of its count
  for (int r = warp; r < bs; r += WARPS) {
    float x[NC];
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int j = q * LANES + lane;
      x[q] = j < bs ? t[(size_t)r * bs + j] : 0.0f;
    }
#pragma unroll
    for (int q0 = 0; q0 < NC; ++q0) {
      const int steps = min(LANES, r - q0 * LANES);
      for (int jj = 0; jj < steps; ++jj) {
        const int c = q0 * LANES + jj;
        if (c >= known) {
          do known = load_acquire(done);
          while (known <= c);
        }
        // row c's entries of this lane's columns from q0 on (0 past bs);
        // the columns below c are read and not used
        const float* uc = u + (size_t)c * bs + q0 * LANES + lane;
        float uv[NC];
#pragma unroll
        for (int q = q0; q < NC; ++q)
          uv[q] = (q < NC - 1 || q * LANES + lane < bs) ? uc[(q - q0) * LANES] : 0.0f;
        const float l = divide(__shfl_sync(FULL_MASK, x[q0], jj),
                               __shfl_sync(FULL_MASK, uv[q0], jj));
        x[q0] = lane > jj ? __fsub_rn(x[q0], __fmul_rn(l, uv[q0])) : lane == jj ? l : x[q0];
        // columns past bs hold 0 and take 0 - l * 0: never stored
#pragma unroll
        for (int q = q0 + 1; q < NC; ++q) x[q] = __fsub_rn(x[q], __fmul_rn(l, uv[q]));
      }
    }
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const int j = q * LANES + lane;
      if (j < bs) u[(size_t)r * bs + j] = x[q];
    }
    store_release(done, r + 1);
  }
  if (IN_SMEM) {
    __syncthreads();
    for (int e = threadIdx.x; e < bs * bs; e += WARPS * LANES) out[e] = u[e];
  }
}

// bs > CHUNK: the rows in chunks of CHUNK columns, final rows read from
// the output. Each chunk has its own count per lane: a row publishes chunk
// k once its entries there are final (after the row before it did), and a
// step c of chunk k waits only for row c's chunk k. So a row's chunks
// pipeline behind the rows before it, and the steps of a chunk's earlier
// columns (its catch-up) stay off the chain of rows. Every wait is for a
// lower row of the same chunk, so the lowest unfinished row can always go
// on: no wait can deadlock.
__global__ void __launch_bounds__(WARPS * LANES)
tile_lu_chunked_kernel(const float* t, float* out, int bs) {
  extern __shared__ int counts[];  // [chunk][lane]: rows whose chunk is final
  const int lane = threadIdx.x % LANES, warp = threadIdx.x / LANES;
  const int n_chunks = (bs + CHUNK - 1) / CHUNK;
  for (int i = threadIdx.x; i < n_chunks * LANES; i += blockDim.x) counts[i] = 0;
  __syncthreads();
  for (int r = warp; r < bs; r += WARPS) {
    const size_t row = (size_t)r * bs;
    for (int cb = 0; cb < bs; cb += CHUNK) {
      int* done = counts + (cb / CHUNK) * LANES + lane;  // this lane's count of chunk cb
      int known = 0;  // this lane's last reading of it
      float x[MAX_NC];
#pragma unroll
      for (int q = 0; q < MAX_NC; ++q) {
        const int j = cb + q * LANES + lane;
        x[q] = j < bs ? t[row + j] : 0.0f;
      }
      const int early = min(r, cb);
      for (int c = 0; c < early; ++c) {  // the earlier chunks' steps, ascending
        if (c >= known) {
          do known = load_acquire(done);
          while (known <= c);
        }
        const float l = out[row + c];  // final: written by this warp
        const float* uc = out + (size_t)c * bs + cb + lane;
#pragma unroll
        for (int q = 0; q < MAX_NC; ++q) {
          const float uv = cb + q * LANES + lane < bs ? uc[q * LANES] : 0.0f;
          x[q] = __fsub_rn(x[q], __fmul_rn(l, uv));
        }
      }
#pragma unroll
      for (int q0 = 0; q0 < MAX_NC; ++q0) {
        const int steps = min(LANES, r - cb - q0 * LANES);
        for (int jj = 0; jj < steps; ++jj) {
          const int c = cb + q0 * LANES + jj;
          if (c >= known) {
            do known = load_acquire(done);
            while (known <= c);
          }
          const float* uc = out + (size_t)c * bs + cb + q0 * LANES + lane;
          float uv[MAX_NC];
#pragma unroll
          for (int q = q0; q < MAX_NC; ++q)
            uv[q] = cb + q * LANES + lane < bs ? uc[(q - q0) * LANES] : 0.0f;
          const float l = divide(__shfl_sync(FULL_MASK, x[q0], jj),
                                 __shfl_sync(FULL_MASK, uv[q0], jj));
          x[q0] = lane > jj ? __fsub_rn(x[q0], __fmul_rn(l, uv[q0])) : lane == jj ? l : x[q0];
#pragma unroll
          for (int q = q0 + 1; q < MAX_NC; ++q) x[q] = __fsub_rn(x[q], __fmul_rn(l, uv[q]));
        }
      }
#pragma unroll
      for (int q = 0; q < MAX_NC; ++q) {
        const int j = cb + q * LANES + lane;
        if (j < bs) out[row + j] = x[q];
      }
      __syncwarp();  // the chunk's L entries, read back by every lane
      if (r > known) {  // chunks are published in row order
        do known = load_acquire(done);
        while (known < r);
      }
      store_release(done, r + 1);
    }
  }
}

// The chain floor: the same warps, rows and count exchanges with no
// arithmetic and no tile, so its time is the chain of bs exchanges alone.
__global__ void __launch_bounds__(WARPS * LANES) tile_lu_chain_floor_kernel(int bs, int* sink) {
  __shared__ int counts[LANES];
  int* done = counts + threadIdx.x % LANES;
  const int warp = threadIdx.x / LANES;
  if (threadIdx.x < LANES) *done = 0;
  __syncthreads();
  int known = 0, waits = 0;
  for (int r = warp; r < bs; r += WARPS) {
    if (r - 1 >= known) {
      do known = load_acquire(done), ++waits;
      while (known <= r - 1);
    }
    store_release(done, r + 1);
  }
  if (threadIdx.x == 0) *sink = waits;
}

static size_t smem_bytes(int bs, bool in_smem) {
  return (HEAD + (in_smem ? (size_t)bs * bs : 0)) * sizeof(float);
}

template <int NC>
static cudaError_t launch(const float* t, float* out, int bs, int optin, cudaStream_t stream) {
  if constexpr (NC < MAX_NC) {
    if (NC * LANES < bs) return launch<NC + 1>(t, out, bs, optin, stream);
  }
  if (bs > CHUNK) {
    const size_t counts = (size_t)((bs + CHUNK - 1) / CHUNK) * LANES * sizeof(int);
    if (counts > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          tile_lu_chunked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)counts);
      if (err != cudaSuccess) return err;
    }
    tile_lu_chunked_kernel<<<1, WARPS * LANES, counts, stream>>>(t, out, bs);
    return cudaGetLastError();
  }
  const bool fits = smem_bytes(bs, true) <= (size_t)optin;
  if constexpr (NC <= SMEM_NC) {
    if (fits) {
      const size_t smem = smem_bytes(bs, true);
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            tile_lu_kernel<NC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
      }
      tile_lu_kernel<NC, true><<<1, WARPS * LANES, smem, stream>>>(t, out, bs);
      return cudaGetLastError();
    }
  }
  if constexpr (NC >= SMEM_NC) {
    tile_lu_kernel<NC, false><<<1, WARPS * LANES, smem_bytes(bs, false), stream>>>(t, out, bs);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

extern "C" int tile_lu_launch(const void* t, void* out, int bs, void* stream) {
  if (bs < 1) return (int)cudaErrorInvalidValue;
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  return (int)launch<1>((const float*)t, (float*)out, bs, optin, (cudaStream_t)stream);
}

// `sink` (one int on the device) receives thread 0's count of waits.
extern "C" int tile_lu_chain_floor_launch(int bs, void* sink, void* stream) {
  tile_lu_chain_floor_kernel<<<1, WARPS * LANES, 0, (cudaStream_t)stream>>>(bs, (int*)sink);
  return (int)cudaGetLastError();
}
