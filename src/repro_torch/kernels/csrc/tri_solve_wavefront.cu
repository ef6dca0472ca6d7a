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
// slot is the scratch slot (n_slots) are skipped. The level body is
// level_row_sum (level_row.cuh), shared with epoch_sweep.cu. Every slot of
// a level is written, pad rows included, as the reference's
// dynamic_update_slice does. A right-hand side index at the scratch slot
// (b_ext[n], x_l[nl_slots]) reads +0.0, so no vector needs zeroing.
//
// Bound: the chain of levels, not bytes. A few MB move, but the L levels
// and then the U levels depend on each other in sequence, so the time is
// the number of levels times one level's latency. A level's rows run in
// one block with a __syncthreads() between levels; one block per right-
// hand side. On that chain a scattered access to device memory is the
// costly part: one SM issues about one 32-byte request per cycle, so a
// level's 200 scattered loads cost more than its arithmetic. The design
// takes every scattered access off the chain:
//
// * The three permutations of the apply -- b into L slot order, x_l into
//   U slot order, x_u into row order -- are gathers over all the card's
//   SMs (permute_kernel), launched on the same stream around the two
//   sweeps. Each sweep finds its right-hand side in slot order in the
//   sweep vector itself and overwrites it, level by level, with x.
// * The static data ahead of the chain. A level's cols, vals, right-hand
//   side and (U) diag do not depend on this sweep's x, so they are staged
//   into a pipeline of STAGES chunks of `g` consecutive levels in shared
//   memory: one cp.async.bulk per array and chunk, counted on the stage's
//   mbarrier, when every chunk is 16-byte aligned and sized (maxr a
//   multiple of 4), else 4-byte cp.async, each thread arriving on the
//   stage's mbarrier when its copies land. One wait per chunk.
// * The sweep window. A row gathers slots of earlier levels, and in a
//   wavefront plan the distance back is small (1 or 2 levels for a 5-point
//   stencil). Each block keeps its latest levels in a ring in shared memory
//   of a power-of-two size P >= R*maxr, R the plan's largest gather
//   distance plus one (reckoned once on the host per plan), capped by the
//   shared memory a block may take; slot c sits at c & (P-1). When P
//   covers R levels (COVERED, always so unless capped) every gather reads
//   the ring; otherwise a gather older than the ring reads the device
//   copy, which every level also writes. Where a value is read from never
//   changes it, so the bits do not depend on P.
// * Covered rows in few instructions. Per level the block issues every
//   row's instructions on 4 schedulers, so a row's instruction count sets
//   the chain as much as its latency does. For a covered sweep the wrapper
//   makes, once per plan, a copy of cols/vals with W padded to a multiple
//   of 4, each column turned into its ring offset (c & (P-1)) and each
//   masked or padded lane into the ring's zero slot P with value 0. A row
//   is then 16-byte loads of 4 lanes, 4 gathers, 4 rounded products and
//   adds, no compare and no branch. A masked lane adds 0 * 0 = +0.0, which
//   leaves the sum as it was: it starts at +0.0, and under round-to-nearest
//   a sum that starts at +0.0 is never -0.0, the one value that adding
//   +0.0 would change. So the bits are those of skipping the lane.
//
// A link of the chain is then: gathers from shared memory, at most W
// rounded products, a subtract (and a divide), two stores, one barrier.
// When STAGES chunks of one level do not fit beside the ring (very wide
// levels) a sweep runs unstaged: its static data is read from device
// memory; the ring still serves the gathers. tri_solve_sweep_config()
// fixes each sweep's staging, chunk, ring, width and threads per plan,
// once.
//
// Batched form: every kernel takes the right-hand side as its grid's last
// dimension; sweep block `lane` runs the unchanged level loop on its own
// rows of x_l / x_u (nb, slots). The blocks share the read-only factor
// arrays and nothing else, so a lane's bits do not depend on nb.
#include <cuda_runtime.h>
#include <stdint.h>

#include "level_row.cuh"

#define STAGES 4     // chunks of static data in flight
#define MAX_CHUNK 8  // levels per chunk
#define HEADER 64    // bytes before the ring: one mbarrier per stage
#define PERMUTE_THREADS 256

enum Staging { UNSTAGED = 0, ASYNC = 1, BULK = 2 };

// Offsets, in 4-byte words, of one stage's arrays for a chunk of g levels;
// each a multiple of 4 words, so every array starts 16-byte aligned.
struct StageLayout {
  int cols, vals, rhs, diag, words;
};

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline StageLayout stage_layout(int maxr, int w, int g, bool diag) {
  StageLayout s;
  s.cols = 0;
  s.vals = s.cols + round4(g * maxr * w);
  s.rhs = s.vals + round4(g * maxr * w);
  s.diag = s.rhs + round4(g * maxr);
  s.words = s.diag + (diag ? round4(g * maxr) : 0);
  return s;
}

// One triangular sweep's level-major arrays.
struct Sweep {
  const int* cols;
  const float* vals;
  const float* diag;  // null for the unit-diagonal L sweep
  float* x;           // nb rows of n_slots: the right-hand side in slot order, then x
  int nlev, maxr, w;  // w: lanes per row as staged (a multiple of 4 when covered)
  int ring;           // slots of the shared-memory ring: a power of two >= maxr, or 0
};

// A slot's value in a sweep that the ring does not cover: from the ring
// when the level being written does not overwrite it (c >= lo), else from
// the device copy.
struct Window {
  const float* ring;
  const float* x;
  int lo, mask;
  __device__ __forceinline__ float operator[](int c) const {
    float v = ring[c & mask];
    if (c < lo) v = x[c];
    return v;
  }
};

// A covered row: lanes by fours, columns as ring offsets (the zero slot
// for a masked lane, whose value is 0), ascending.
__device__ __forceinline__ float ring_row_sum(const int* cols, const float* vals,
                                              const float* ring, int w4) {
  const int4* c4 = reinterpret_cast<const int4*>(cols);
  const float4* v4 = reinterpret_cast<const float4*>(vals);
  float acc = 0.0f;
  for (int q = 0; q < w4 / 4; ++q) {
    const int4 c = c4[q];
    const float4 v = v4[q];
    const float g0 = ring[c.x], g1 = ring[c.y], g2 = ring[c.z], g3 = ring[c.w];
    acc = __fadd_rn(acc, __fmul_rn(v.x, g0));
    acc = __fadd_rn(acc, __fmul_rn(v.y, g1));
    acc = __fadd_rn(acc, __fmul_rn(v.z, g2));
    acc = __fadd_rn(acc, __fmul_rn(v.w, g3));
  }
  return acc;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// The stage's mbarrier counts this thread's arrival once its copies land.
__device__ __forceinline__ void arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Chunk k (levels k*g ..) of S's static data and right-hand side into the
// stage at `st`, counted on `bar`.
template <int MODE>
__device__ __forceinline__ void stage_chunk(const Sweep& S, int k, int g, int* st,
                                            const StageLayout& L, uint64_t* bar) {
  const int lev0 = k * g, cnt = min(g, S.nlev - lev0);
  const int rw = S.maxr * S.w, big = cnt * rw, small = cnt * S.maxr;
  const size_t at = (size_t)lev0 * rw, ar = (size_t)lev0 * S.maxr;
  if (MODE == BULK) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, 4u * (2 * big + small + (S.diag ? small : 0)));
      bulk_copy(st + L.cols, S.cols + at, 4u * big, bar);
      bulk_copy(st + L.vals, S.vals + at, 4u * big, bar);
      bulk_copy(st + L.rhs, S.x + ar, 4u * small, bar);
      if (S.diag) bulk_copy(st + L.diag, S.diag + ar, 4u * small, bar);
    }
  } else {
    for (int i = threadIdx.x; i < big; i += blockDim.x) {
      copy4(st + L.cols + i, S.cols + at + i);
      copy4(st + L.vals + i, S.vals + at + i);
    }
    for (int i = threadIdx.x; i < small; i += blockDim.x) {
      copy4(st + L.rhs + i, S.x + ar + i);
      if (S.diag) copy4(st + L.diag + i, S.diag + ar + i);
    }
    arrive_on_copies(bar);
  }
}

// One sweep over S's levels for right-hand side blockIdx.x, in chunks of
// g levels. In place: slot s of S.x holds the right-hand side until its
// level writes x there.
template <int MODE, bool COVERED>
__global__ void __launch_bounds__(1024) tri_sweep_kernel(Sweep S, int g) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + HEADER);
  int* stages = reinterpret_cast<int*>(ring + S.ring + 4);  // the ring, its zero slot, padding
  const StageLayout L = stage_layout(S.maxr, S.w, g, S.diag != nullptr);
  const int maxr = S.maxr, w = S.w, n_slots = S.nlev * maxr;
  const int n_chunks = (S.nlev + g - 1) / g, mask = S.ring ? S.ring - 1 : 0;
  S.x += blockIdx.x * (size_t)n_slots;
  if (COVERED && threadIdx.x == 0) ring[S.ring] = 0.0f;  // the zero slot of masked lanes
  if (COVERED || MODE != UNSTAGED) {
    if (MODE != UNSTAGED && threadIdx.x == 0) {
      for (int i = 0; i < STAGES; ++i) mbar_init(bars + i, MODE == BULK ? 1 : blockDim.x);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  if (MODE != UNSTAGED) {
    for (int k = 0; k < STAGES && k < n_chunks; ++k)
      stage_chunk<MODE>(S, k, g, stages + k * L.words, L, bars + k);
  }
  int lev = 0;
  for (int k = 0; k < n_chunks; ++k) {
    const int stage = k % STAGES;
    const int* st = stages + stage * L.words;
    if (MODE != UNSTAGED) mbar_wait(bars + stage, (k / STAGES) & 1);
    const int cnt = min(g, S.nlev - k * g);
    for (int j = 0; j < cnt; ++j, ++lev) {
      // the ring's slots that this level does not overwrite: from lo on
      const Window xw{ring, S.x, S.ring ? (lev + 1) * maxr - S.ring : n_slots, mask};
      for (int r = threadIdx.x; r < maxr; r += blockDim.x) {
        const int s = lev * maxr + r;
        const int* c;
        const float* v;
        float rhs, d = 1.0f;
        if (MODE != UNSTAGED) {
          const int e = j * maxr + r;
          c = st + L.cols + e * w;
          v = reinterpret_cast<const float*>(st + L.vals) + e * w;
          rhs = reinterpret_cast<const float*>(st + L.rhs)[e];
          if (S.diag) d = reinterpret_cast<const float*>(st + L.diag)[e];
        } else {
          c = S.cols + (size_t)s * w;
          v = S.vals + (size_t)s * w;
          rhs = S.x[s];
          if (S.diag) d = S.diag[s];
        }
        const float acc = COVERED ? ring_row_sum(c, v, ring, w)
                                  : level_row_sum(c, v, xw, w, n_slots, lev * maxr);
        float y = __fsub_rn(rhs, acc);
        if (S.diag) y = __fdiv_rn(y, d);
        S.x[s] = y;
        if (S.ring) ring[s & mask] = y;
      }
      __syncthreads();
    }
    // the stage is free again: the chunk STAGES ahead goes there
    if (MODE != UNSTAGED && k + STAGES < n_chunks)
      stage_chunk<MODE>(S, k + STAGES, g, stages + stage * L.words, L, bars + stage);
  }
}

// dst[lane][i] = src[lane][idx[i]] for idx[i] < limit, else +0.0; grid
// (ceil(len / PERMUTE_THREADS), nb). The permutations between the sweeps.
__global__ void permute_kernel(const float* __restrict__ src, int src_len,
                               const int* __restrict__ idx, int len, int limit,
                               float* __restrict__ dst) {
  const int i = blockIdx.x * PERMUTE_THREADS + threadIdx.x;
  if (i >= len) return;
  const int k = idx[i];
  dst[blockIdx.y * (size_t)len + i] = k < limit ? src[blockIdx.y * (size_t)src_len + k] : 0.0f;
}

template <int MODE, bool COVERED>
static cudaError_t allow_smem(size_t smem, int optin) {
  if (smem <= 48 * 1024) return cudaSuccess;
  // the largest size any plan may ask for, so that a later, larger plan
  // never meets a limit set by a smaller one
  return cudaFuncSetAttribute(tri_sweep_kernel<MODE, COVERED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
}

static int pow2_ceil(long long x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

static int pow2_floor(long long x) {
  int p = 1;
  while ((long long)p * 2 <= x) p <<= 1;
  return p;
}

struct SweepLayout {
  int mode, ring, g;
  size_t smem;
};

// Staging, ring and chunk of one sweep staged at width w: the ring takes
// the power of two covering `levels` levels (at least one level) that fits
// beside a stage of one level, the chunk then grows to what shared memory
// remains, up to MAX_CHUNK levels.
static SweepLayout lay_out(int maxr, int w, int has_diag, long long levels, int capped,
                           int aligned, size_t budget) {
  auto staged = [&](int g) {
    return (size_t)STAGES * stage_layout(maxr, w, g, has_diag != 0).words * 4;
  };
  SweepLayout lay;
  lay.mode = staged(1) + 32 <= budget ? (aligned ? BULK : ASYNC) : UNSTAGED;
  const long long fit = (long long)(budget - (lay.mode != UNSTAGED ? staged(1) : 0)) / 4 - 4;
  lay.ring = 0;
  if (maxr > 0 && pow2_ceil(maxr) <= fit) {
    lay.ring = capped ? pow2_floor(levels * maxr) : pow2_ceil(levels * maxr);
    if (lay.ring < pow2_ceil(maxr)) lay.ring = pow2_ceil(maxr);
    while (lay.ring > fit) lay.ring >>= 1;
  }
  const size_t ring_bytes = 4 * ((size_t)lay.ring + 4);
  lay.g = 1;
  if (lay.mode != UNSTAGED)
    while (lay.g < MAX_CHUNK && ring_bytes + staged(lay.g + 1) <= budget) ++lay.g;
  lay.smem = HEADER + ring_bytes + (lay.mode != UNSTAGED ? staged(lay.g) : 0);
  return lay;
}

// The layout of one sweep's launches on the current device, fixed once per
// plan: cfg = {staging, ring slots, shared memory bytes, threads, levels
// per chunk, covered, staged width}. `win` is the sweep's window R, or a
// smaller cap when `capped` (never covered then). A sweep whose ring can
// hold R levels is covered and staged at W rounded up to 4 (the wrapper's
// ring-offset copy of cols/vals); otherwise it keeps W and the slot
// columns. `aligned`: the sweep's chunks may go by cp.async.bulk (maxr a
// multiple of 4 and the arrays 16-byte aligned; a covered copy always is).
extern "C" int tri_solve_sweep_config(int nlev, int maxr, int w, int has_diag, int win,
                                      int capped, int aligned, int* cfg) {
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t budget = (size_t)optin - HEADER;
  const long long levels = win < nlev ? win : nlev;
  const int w4 = round4(w);
  SweepLayout lay = lay_out(maxr, w4, has_diag, levels, capped, aligned, budget);
  int covered = !capped && (long long)lay.ring >= levels * maxr, staged_w = w4;
  if (!covered) {
    lay = lay_out(maxr, w, has_diag, levels, capped, aligned, budget);
    staged_w = w;
  }
  int threads = ((maxr + 31) / 32) * 32;
  threads = threads < 32 ? 32 : threads > 1024 ? 1024 : threads;
  const int mode = lay.mode;
  const size_t smem = lay.smem;
  err = mode == BULK    ? (covered ? allow_smem<BULK, true>(smem, optin)
                                   : allow_smem<BULK, false>(smem, optin))
        : mode == ASYNC ? (covered ? allow_smem<ASYNC, true>(smem, optin)
                                   : allow_smem<ASYNC, false>(smem, optin))
                        : (covered ? allow_smem<UNSTAGED, true>(smem, optin)
                                   : allow_smem<UNSTAGED, false>(smem, optin));
  if (err != cudaSuccess) return (int)err;
  cfg[0] = mode;
  cfg[1] = lay.ring;
  cfg[2] = (int)smem;
  cfg[3] = threads;
  cfg[4] = lay.g;
  cfg[5] = covered;
  cfg[6] = staged_w;
  return 0;
}

static void sweep_launch(const Sweep& S, const int* cfg, int nb, cudaStream_t s) {
  const int mode = cfg[0], smem = cfg[2], threads = cfg[3], g = cfg[4], covered = cfg[5];
  if (mode == BULK && covered)
    tri_sweep_kernel<BULK, true><<<nb, threads, smem, s>>>(S, g);
  else if (mode == BULK)
    tri_sweep_kernel<BULK, false><<<nb, threads, smem, s>>>(S, g);
  else if (mode == ASYNC && covered)
    tri_sweep_kernel<ASYNC, true><<<nb, threads, smem, s>>>(S, g);
  else if (mode == ASYNC)
    tri_sweep_kernel<ASYNC, false><<<nb, threads, smem, s>>>(S, g);
  else if (covered)
    tri_sweep_kernel<UNSTAGED, true><<<nb, threads, smem, s>>>(S, g);
  else
    tri_sweep_kernel<UNSTAGED, false><<<nb, threads, smem, s>>>(S, g);
}

static void permute(const float* src, int src_len, const int* idx, int len, int limit,
                    float* dst, int nb, cudaStream_t s) {
  const dim3 grid((len + PERMUTE_THREADS - 1) / PERMUTE_THREADS, nb);
  permute_kernel<<<grid, PERMUTE_THREADS, 0, s>>>(src, src_len, idx, len, limit, dst);
}

// One apply for nb right-hand sides: permute b into L slot order (x_l),
// sweep L, permute x_l into U slot order (x_u), sweep U, permute x_u into
// row order (out). `plan` holds the 8 arrays (l_cols, l_vals, l_rhs_idx,
// u_cols, u_vals, u_diag, u_rhs_idx, out_perm), the cols/vals of a covered
// sweep being the wrapper's ring-offset copy; `cfg` holds {n, nl, maxr_l,
// nu, maxr_u} and then the L and the U sweep's tri_solve_sweep_config()
// outputs.
extern "C" int tri_solve_wavefront_launch(const void* const* plan, const int* cfg, const void* b,
                                          void* x_l, void* x_u, void* out, int nb,
                                          void* stream) {
  const int n = cfg[0], nl = cfg[1], ml = cfg[2], nu = cfg[3], mu = cfg[4];
  const int *lc = cfg + 5, *uc = cfg + 12;
  const cudaStream_t s = (cudaStream_t)stream;
  const Sweep Ls{(const int*)plan[0], (const float*)plan[1], nullptr, (float*)x_l, nl, ml, lc[6],
                 lc[1]};
  const Sweep Us{(const int*)plan[3], (const float*)plan[4], (const float*)plan[5], (float*)x_u,
                 nu, mu, uc[6], uc[1]};
  permute((const float*)b, n, (const int*)plan[2], nl * ml, n, (float*)x_l, nb, s);
  sweep_launch(Ls, lc, nb, s);
  permute((const float*)x_l, nl * ml, (const int*)plan[6], nu * mu, nl * ml, (float*)x_u, nb, s);
  sweep_launch(Us, uc, nb, s);
  permute((const float*)x_u, nu * mu, (const int*)plan[7], n, nu * mu, (float*)out, nb, s);
  return (int)cudaGetLastError();
}

// The chain floor of a sweep (a measurement, not a kernel of the path):
// the same block loops over nlev levels with nothing on each link but a
// shared-memory exchange (each row reads another row's value of the level
// before) and the barrier.
__global__ void chain_floor_kernel(int nlev, int maxr, float* out) {
  extern __shared__ float two[];  // two levels of maxr
  for (int r = threadIdx.x; r < maxr; r += blockDim.x) two[r] = (float)r;
  __syncthreads();
  for (int lev = 1; lev < nlev; ++lev) {
    float* cur = two + (lev & 1) * maxr;
    const float* prev = two + ((lev - 1) & 1) * maxr;
    for (int r = threadIdx.x; r < maxr; r += blockDim.x)
      cur[r] = __fadd_rn(prev[r + 1 < maxr ? r + 1 : 0], 1.0f);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = two[((nlev - 1) & 1) * maxr];
}

extern "C" int tri_solve_chain_floor_launch(int nlev, int maxr, int threads, void* out,
                                            void* stream) {
  const size_t smem = 2 * (size_t)maxr * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  chain_floor_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(nlev, maxr, (float*)out);
  return (int)cudaGetLastError();
}
