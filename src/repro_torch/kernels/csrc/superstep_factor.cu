// The band-superstep (TOP-ILU) factorization, for Hopper (sm_90a), over D
// band owners: one superstep per launch (the per-superstep form), or every
// superstep and every halo exchange in one persistent launch (below).
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

// ---------------------------------------------------------------------------
// The persistent form: a whole factorization, every superstep of every owner
// and every halo exchange, in ONE cooperative launch of D blocks.
//
// Layout: block d is owner d; warp g of it factors member g of the owner's
// superstep (sched[s][d][g]), so a block has 32 * MPD threads and the
// barriers between supersteps order an owner's own bands.
//
// Staging ahead (STAGED): a band's A rows and its per-row tables (n_piv,
// piv_addr, piv_dlane, piv_dst) depend on no earlier superstep, and only
// their own block reads or writes them; warp g copies member g's of
// superstep s + 1 by cp.async into a ring of two buffers in shared memory
// while superstep s is factored (warp 0 also the wait row and push list).
// A superstep then reads shared memory except for the out-of-band pivot
// rows.
//
// The band, in two phases with the bits of the per-superstep form (the same
// rounded operations on every row, its pivots in ascending order):
//   1. the warp copies the band's out-of-band pivot rows (rows finished in
//      earlier supersteps) from `state` into shared memory by cp.async,
//      all in flight together (a dependent load per entry took one L2 trip
//      each); then lane r takes row r's leading out-of-band pivots: the
//      rows are independent there, so 32 rows go at once;
//   2. the rows in order, each taking its remaining pivots (in-band rows
//      from the buffer): for W <= 32 with the row in registers, lane t
//      holding x[t] (phase2_registers); wider, with the warp's lanes over
//      the W lanes, two __syncwarp per pivot ordering the read of x[p]
//      before the updates and the updates before the next pivot. A
//      destination lane equal to p is skipped: x[p] = l overwrites it in
//      the reference as well.
//
// Exchange (push): after superstep s owner d writes each row of its push
// list (the plan's egress rows, each with the receiver's ingress address;
// scratch entries dropped on the host) into the receiver's halo, then
// publishes s + 1 with a release store of its count. Before superstep s,
// owner r acquires, for every sender t, count >= wait[s][r][t]: one past
// the latest superstep in which t filled a halo row that r reads in s (0:
// no wait). A push instead of a pull keeps the receiver's copy off the
// chain: the receiver only reads the rows it needs.
//
// Why no grid barrier (checked on the host when the tables are bound): each
// halo row is filled by one ingress entry per factorization, in a superstep
// before every superstep that reads it, and from a row its sender finished
// in that superstep and never writes again; an owner reads another's rows
// only through its own halo, and writes another's state only in its halo.
// Waits name only earlier supersteps, whose counts every owner publishes
// before it waits again, so none deadlocks. All D blocks must be resident:
// the launch is cooperative, and refused when they do not fit. A wait is
// bounded and ends in __trap(), so a fault in the protocol ends in a launch
// error, never in a hang. The counts are zeroed on the stream per launch.
//
// Wide bands (not STAGED): a band above shared memory is factored in place
// in `state` with the tables read where they lie, phase 2 alone (the same
// order of rounded operations), and pushed from `state`.
//
// Bound: the chain. A superstep costs its wait, phase 1's pivot-row reads,
// and phase 2's chain of in-band pivots in shared memory (a divide, the
// lane updates and two __syncwarp each), and the band factorization is
// nearly a chain of supersteps (the plan's fullest superstep holds a few
// bands).

#define SPIN_LIMIT (1ll << 24)  // polls of a count before a wait traps (seconds)
#define RING 2                  // supersteps in the shared-memory ring

struct Factor {
  float* state;          // (D, srows, W)
  const int* sched;      // (n_sup, D, MPD)
  const int* piv_addr;   // (D, s_loc, MP)
  const int* piv_dlane;  // (D, s_loc, MP)
  const int* piv_dst;    // (D, s_loc, MP, W)
  const int* n_piv;      // (D, s_loc)
  const int* push_off;   // (n_sup * D + 1): entries of (s, d) at [push_off[s*D+d], ...+1)
  const int* push_src;   // member-relative row g * R + r of the sender's superstep
  const int* push_dst;   // the receiver's flat state row, r * srows + halo row
  const int* wait;       // (n_sup, D, D)
  unsigned* flags;       // (D): superstep counts
  int n_sup, n_owners, mpd, srows, s_loc, R, W, MP, n_bands, p_max;
};

__device__ __forceinline__ unsigned ss_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ss_copy4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(ss_smem(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ unsigned ss_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void ss_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Words of one band member's slot: values R*W, then n_piv R, piv_addr R*MP,
// piv_dlane R*MP, piv_dst R*MP*W and phase 1's pivot counts R.
__host__ __device__ __forceinline__ size_t member_words(int R, int W, int MP) {
  return (size_t)R * W + (size_t)R * (2 + 2 * MP + MP * W);
}

// Words of one warp's scratch: the pulled pivot rows (R*MP*W floats), the
// inverted destination maps of phase 2 (R*MP*W), its pivots' addresses and
// pivot lanes (R*MP each) and counts (R).
__host__ __device__ __forceinline__ size_t scratch_words(int R, int W, int MP) {
  return 2 * (size_t)R * MP * W + 2 * (size_t)R * MP + R;
}

// Words of one ring slot: MPD members, the wait row (D), the push list
// (2 * p_max).
__host__ __device__ __forceinline__ size_t slot_words(int R, int W, int MP, int mpd, int D,
                                                      int p_max) {
  return (size_t)mpd * member_words(R, W, MP) + D + 2 * (size_t)p_max;
}

// A pivot row's entry: an in-band row (this warp's own writes) by a plain
// load, a finished row (written by another block, or by this one in an
// earlier superstep) from L2.
__device__ __forceinline__ float ss_row(const float* pv, bool in_band, int i) {
  return in_band ? pv[i] : __ldcg(pv + i);
}

// Warp g's member of superstep s into `slot` (band b, or none); warp 0 also
// the wait row and the push list [lo, hi).
__device__ void stage(const Factor& F, int* slot, int d, int s, int b, int lo, int hi) {
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int R = F.R, W = F.W, MP = F.MP, D = F.n_owners;
  int* tail = slot + (size_t)F.mpd * member_words(R, W, MP);
  if (b < F.n_bands) {
    const int base = (b / D) * R;
    const size_t row0 = (size_t)d * F.s_loc + base;
    int* m = slot + (size_t)g * member_words(R, W, MP);
    const float* gv = F.state + ((size_t)d * F.srows + base) * W;
    for (int i = lane; i < R * W; i += 32) ss_copy4(m + i, gv + i);
    int* t = m + R * W;
    for (int i = lane; i < R; i += 32) ss_copy4(t + i, F.n_piv + row0 + i);
    t += R;
    for (int i = lane; i < R * MP; i += 32) ss_copy4(t + i, F.piv_addr + row0 * MP + i);
    t += R * MP;
    for (int i = lane; i < R * MP; i += 32) ss_copy4(t + i, F.piv_dlane + row0 * MP + i);
    t += R * MP;
    for (int i = lane; i < R * MP * W; i += 32) ss_copy4(t + i, F.piv_dst + row0 * MP * W + i);
  }
  if (g == 0) {
    const int* wr = F.wait + ((size_t)s * D + d) * D;
    for (int i = lane; i < D; i += 32) ss_copy4(tail + i, wr + i);
    for (int i = lane; i < hi - lo; i += 32) {
      ss_copy4(tail + D + i, F.push_src + lo + i);
      ss_copy4(tail + D + F.p_max + i, F.push_dst + lo + i);
    }
  }
}

// Phase 2 for W <= 32 with the row in registers (lane t holds x[t]): per
// pivot the pivot entry and x[p] come by shuffles (the row before from its
// registers), l by the divide, and lane t takes the product of the pivot
// row's lane inv[t] (the destination map inverted in phase 1; -1: no
// update, and never t = p). No shared-memory trip and no __syncwarp lie on
// the chain: phase 1 lays each row's phase-2 pivots out by their index k
// (address, pivot lane, inverted map, count), so the next row's values and
// its first pivot's tables are loaded a row ahead from addresses that
// depend on the row alone; a finished row goes to the band buffer, and a
// pivot row older than the row before (read from there) is preceded by a
// __syncwarp.
__device__ void phase2_registers(const Factor& F, int base, float* X, const int* first,
                                 const int* inv) {
  const int t = threadIdx.x & 31;
  const int R = F.R, W = F.W, MP = F.MP;
  const float* st = F.state + (size_t)blockIdx.x * F.srows * W;
  const int* qa = inv + R * MP * W;  // per (row, k): the pivot row's address,
  const int* qd = qa + R * MP;       // its pivot lane, then the count per row
  float prev = 0.0f;                 // row r - 1, finished
  // row r's values, count, first pivot and that pivot's tables, a row ahead
  float x_nx = t < W ? X[t] : 0.0f;
  int n_nx = qd[R * MP], f_nx = first[0], a_nx = qa[0], d_nx = qd[0];
  int s_nx = t < W ? inv[t] : -1;
  for (int r = 0; r < R; ++r) {
    float x = x_nx;
    const int n = n_nx, f = f_nx, a0 = a_nx, d0 = d_nx, s0 = s_nx;
    if (r + 1 < R) {
      const int q = (r + 1) * MP;
      x_nx = t < W ? X[(r + 1) * W + t] : 0.0f;
      n_nx = qd[R * MP + r + 1], f_nx = first[r + 1], a_nx = qa[q], d_nx = qd[q];
      s_nx = t < W ? inv[q * W + t] : -1;
    }
    for (int k = 0; k < n; ++k) {
      const int q = r * MP + k, p = f + k;
      const int a = k ? qa[q] : a0, lane_d = k ? qd[q] : d0;
      const int src = k ? (t < W ? inv[q * W + t] : -1) : s0;
      const int li = a - base;
      float piv, pvs;
      if (li >= 0 && li == r - 1) {  // the row before: from its registers
        piv = __shfl_sync(0xffffffffu, prev, lane_d);
        pvs = __shfl_sync(0xffffffffu, prev, src < 0 ? 0 : src);
      } else if (li >= 0 && li < R) {  // an earlier row of the band
        __syncwarp();  // its lanes' stores are seen
        piv = X[li * W + lane_d];
        pvs = src < 0 ? 0.0f : X[li * W + src];
      } else {
        piv = __ldcg(st + (size_t)a * W + lane_d);
        pvs = src < 0 ? 0.0f : __ldcg(st + (size_t)a * W + src);
      }
      const float l = __fdiv_rn(__shfl_sync(0xffffffffu, x, p), piv);
      if (src >= 0) x = __fsub_rn(x, __fmul_rn(l, pvs));
      if (t == p) x = l;
    }
    if (t < W) X[r * W + t] = x;  // the caller's barrier orders it before the push
    prev = x;
  }
}

// Warp-wide, STAGED: copy the out-of-band pivot rows of every row of band
// `base` (member slot `m`) from `state` into `pulled` (R*MP*W floats, at
// r*MP + p) by cp.async, all in flight together, and wait for them. A
// lane takes the pivots (r, p) = (rp / MP, rp % MP), rp = lane, lane + 32,
// ...; the quotient by a float reciprocal, exact for rp < 2^20 (the true
// quotient lies at least 0.5 / MP from an integer). These rows were
// written by other blocks (the senders' pushes, acquired by the wait) or
// by this block in earlier supersteps.
__device__ void pull_rows(const Factor& F, int base, const int* m, float* pulled) {
  const int lane = threadIdx.x & 31;
  const int R = F.R, W = F.W, MP = F.MP;
  const float* st = F.state + (size_t)blockIdx.x * F.srows * W;
  const int* np = m + R * W;
  const int* ad = np + R;
  const float inv_mp = __frcp_rn((float)MP);
  for (int rp = lane; rp < R * MP; rp += 32) {
    const int r = (int)__fmul_rn((float)rp + 0.5f, inv_mp);
    const int a = ad[rp];
    if (rp - r * MP < np[r] && !(a >= base && a < base + R)) {
      const float* src = st + (size_t)a * W;
      float* dst = pulled + rp * W;
      for (int w = 0; w < W; ++w) ss_copy4(dst + w, src + w);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// Warp-wide: factor band b (first local row `base`) of owner d. STAGED: the
// band's values and tables in the member slot `m`, the warp's scratch at
// `pulled` (scratch_words); else in place in state.
template <bool STAGED>
__device__ void factor_band(const Factor& F, int d, int base, int* m, float* pulled) {
  const int lane = threadIdx.x & 31;
  const int R = F.R, W = F.W, MP = F.MP;
  const float* st = F.state + (size_t)d * F.srows * W;  // owner d's rows
  const size_t row0 = (size_t)d * F.s_loc + base;
  float* X = STAGED ? (float*)m : F.state + ((size_t)d * F.srows + base) * W;
  const int* np = STAGED ? m + R * W : F.n_piv + row0;
  const int* ad = STAGED ? np + R : F.piv_addr + row0 * MP;
  const int* dl = STAGED ? ad + R * MP : F.piv_dlane + row0 * MP;
  const int* ds = STAGED ? dl + R * MP : F.piv_dst + row0 * MP * W;
  int* first = STAGED ? (int*)(ds + R * MP * W) : nullptr;
  int* inv = (int*)(pulled + R * MP * W);
  if (STAGED) {  // the out-of-band pivot rows are in `pulled` (pull_rows)
    // phase 1: each row's leading out-of-band pivots, rows at once; then
    // the destination maps of the row's other pivots, inverted (W <= 32)
    for (int r = lane; r < R; r += 32) {
      const int n = np[r];
      float* x = X + r * W;
      int p = 0;
      for (; p < n; ++p) {
        const int a = ad[r * MP + p];
        if (a >= base && a < base + R) break;
        const float* pv = pulled + (r * MP + p) * W;
        const float l = __fdiv_rn(x[p], pv[dl[r * MP + p]]);
        const int* dst = ds + (r * MP + p) * W;
#pragma unroll 4
        for (int w = 0; w < W; ++w) {
          const int dw = dst[w];
          if (dw < W && dw != p) x[dw] = __fsub_rn(x[dw], __fmul_rn(l, pv[w]));
        }
        x[p] = l;
      }
      first[r] = p;
      if (W <= 32) {  // row r's phase-2 pivots k = 0, 1, ... for the chain
        int* qa = inv + R * MP * W;
        int* qd = qa + R * MP;
        qd[R * MP + r] = n - p;
        for (int k = 0; p < n; ++p, ++k) {
          qa[r * MP + k] = ad[r * MP + p];
          qd[r * MP + k] = dl[r * MP + p];
          int* iv = inv + (r * MP + k) * W;
          const int* dst = ds + (r * MP + p) * W;
          for (int w = 0; w < W; ++w) iv[w] = -1;
          for (int w = 0; w < W; ++w)
            if (dst[w] < W && dst[w] != p) iv[dst[w]] = w;
        }
      }
    }
    __syncwarp();
    if (W <= 32) {
      phase2_registers(F, base, X, first, inv);
      return;
    }
  }
  for (int r = 0; r < R; ++r) {  // phase 2: the rows in order
    const int n = np[r];
    float* x = X + (size_t)r * W;
    for (int p = STAGED ? first[r] : 0; p < n; ++p) {
      const int a = ad[r * MP + p];
      const int li = a - base;
      const bool in_band = li >= 0 && li < R;
      const float* pv = in_band ? X + (size_t)li * W : st + (size_t)a * W;
      const float l = __fdiv_rn(x[p], ss_row(pv, in_band, dl[r * MP + p]));
      __syncwarp();  // every lane has read x[p]
      const int* dst = ds + (size_t)(r * MP + p) * W;
      for (int w = lane; w < W; w += 32) {
        const int dw = dst[w];
        if (dw < W && dw != p) x[dw] = __fsub_rn(x[dw], __fmul_rn(l, ss_row(pv, in_band, w)));
      }
      if (lane == 0) x[p] = l;
      __syncwarp();  // the row is complete for the next pivot
    }
  }
}

template <bool STAGED>
__global__ void superstep_factor_persistent_kernel(Factor F) {
  extern __shared__ int ring[];
  const int d = blockIdx.x, g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = F.n_owners, R = F.R, W = F.W;
  const size_t words = slot_words(R, W, F.MP, F.mpd, D, F.p_max);
  const size_t mwords = member_words(R, W, F.MP);
  const int* sched = F.sched + (size_t)d * F.mpd + g;  // + s * D * MPD
  const size_t s_stride = (size_t)D * F.mpd;
  // this warp's band and the owner's push range, for s and s + 1
  int b_cur = sched[0], lo_cur = F.push_off[d], hi_cur = F.push_off[d + 1];
  int b_nxt = F.n_bands, lo_nxt = 0, hi_nxt = 0;
  if (F.n_sup > 1) {
    b_nxt = sched[s_stride];
    lo_nxt = F.push_off[D + d];
    hi_nxt = F.push_off[D + d + 1];
  }
  if (STAGED) {
    stage(F, ring, d, 0, b_cur, lo_cur, hi_cur);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int s = 0; s < F.n_sup; ++s) {
    int b_2 = F.n_bands, lo_2 = 0, hi_2 = 0;  // superstep s + 2, loaded ahead
    if (s + 2 < F.n_sup) {
      b_2 = sched[(size_t)(s + 2) * s_stride];
      lo_2 = F.push_off[(size_t)(s + 2) * D + d];
      hi_2 = F.push_off[(size_t)(s + 2) * D + d + 1];
    }
    int* slot = ring + (size_t)(s % RING) * words;
    int* tail = slot + (size_t)F.mpd * mwords;
    if (STAGED) asm volatile("cp.async.wait_group 0;\n" ::: "memory");  // superstep s landed
    if (g == 0) {  // the wait: lane t polls the senders it staged the row of
      const int* wr = STAGED ? tail : F.wait + ((size_t)s * D + d) * D;
      for (int t = lane; t < D; t += 32) {
        const unsigned need = (unsigned)wr[t];
        if (t == d || need == 0) continue;
        long long polls = 0;
        while (ss_acquire(F.flags + t) < need)
          if (++polls > SPIN_LIMIT) __trap();
      }
    }
    __syncthreads();
    float* pulled = (float*)(ring + RING * words + g * scratch_words(R, W, F.MP));
    if (STAGED && b_cur < F.n_bands) pull_rows(F, (b_cur / D) * R, slot + g * mwords, pulled);
    if (STAGED && s + 1 < F.n_sup) {  // superstep s + 1 flies while s is factored
      stage(F, ring + (size_t)((s + 1) % RING) * words, d, s + 1, b_nxt, lo_nxt, hi_nxt);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    if (b_cur < F.n_bands)
      factor_band<STAGED>(F, d, (b_cur / D) * R, slot + (size_t)g * mwords, pulled);
    __syncthreads();
    const int n_push = hi_cur - lo_cur;
    if (n_push > 0) {
      const int* src = STAGED ? tail + D : F.push_src + lo_cur;
      const int* dst = STAGED ? tail + D + F.p_max : F.push_dst + lo_cur;
      for (int e = threadIdx.x; e < n_push; e += blockDim.x) {
        const int gr = src[e], mg = gr / R, r = gr % R;
        const float* from =
            STAGED ? (const float*)(slot + (size_t)mg * mwords) + r * W
                   : F.state + ((size_t)d * F.srows +
                                (F.sched[(size_t)s * s_stride + (size_t)d * F.mpd + mg] / D) * R +
                                r) * W;
        float* to = F.state + (size_t)dst[e] * W;
#pragma unroll 4
        for (int w = 0; w < W; ++w) to[w] = from[w];
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        ss_release(F.flags + d, (unsigned)(s + 1));
      }
    }
    if (STAGED && b_cur < F.n_bands) {  // write the band back: later supersteps read it
      const float* m = (const float*)(slot + (size_t)g * mwords);
      float* out = F.state + ((size_t)d * F.srows + (size_t)(b_cur / D) * R) * W;
      for (int i = lane; i < R * W; i += 32) out[i] = m[i];
    }
    b_cur = b_nxt, lo_cur = lo_nxt, hi_cur = hi_nxt;
    b_nxt = b_2, lo_nxt = lo_2, hi_nxt = hi_2;
  }
}

// The chain floor: per superstep one wait on the count of the owner before
// (the band before lies there), `chain` dependent steps of a shared-memory
// read, the divide and two __syncwarp, and one release; no data.
__global__ void superstep_factor_chain_floor_kernel(int n_sup, int chain, int n_owners,
                                                    unsigned* flags, float* sink) {
  __shared__ float x[32];
  const int d = blockIdx.x, lane = threadIdx.x;
  x[lane] = 1.0f;
  __syncwarp();
  for (int s = 0; s < n_sup; ++s) {
    if (lane == 0 && n_owners > 1 && s > 0) {
      long long polls = 0;
      while (ss_acquire(flags + (d + n_owners - 1) % n_owners) < (unsigned)s)
        if (++polls > SPIN_LIMIT) __trap();
    }
    __syncwarp();
    for (int c = 0; c < chain; ++c) {
      const float l = __fdiv_rn(x[c & 31], x[(c + 1) & 31]);
      __syncwarp();
      if (lane == 0) x[c & 31] = l;
      __syncwarp();
    }
    if (lane == 0) {
      __threadfence();
      ss_release(flags + d, (unsigned)(s + 1));
    }
  }
  if (lane == 0 && x[0] != 1.0f) *sink = x[0];
}

// The ring, then per warp its scratch (scratch_words).
static size_t persistent_smem(const int* cfg, int staged) {
  // cfg: n_sup, D, MPD, srows, s_loc, R, W, MP, n_bands, p_max
  const size_t pulled = (size_t)cfg[2] * scratch_words(cfg[5], cfg[6], cfg[7]);
  return staged ? (RING * slot_words(cfg[5], cfg[6], cfg[7], cfg[2], cfg[1], cfg[9]) + pulled) * 4
                : 0;
}

static cudaError_t persistent_prepare(int staged, size_t smem) {
  if (!staged || smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(superstep_factor_persistent_kernel<true>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The most owners the current device holds resident at once for the
// configuration `cfg` (see superstep_factor_persistent_launch): the
// cooperative launch refuses more. *smem_out: the ring's bytes per block.
// A ring above the block's shared memory gives 0 (the wrapper then takes
// the in-place form).
extern "C" int superstep_factor_max_owners(const int* cfg, int staged, int* out, int* smem_out) {
  const size_t smem = persistent_smem(cfg, staged);
  *smem_out = (int)smem;
  *out = 0;
  int dev, sms, per_sm, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess || smem > (size_t)optin) return (int)err;
  err = persistent_prepare(staged, smem);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = staged ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, superstep_factor_persistent_kernel<true>, 32 * cfg[2], smem)
                 : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       &per_sm, superstep_factor_persistent_kernel<false>, 32 * cfg[2], 0);
  if (err == cudaSuccess) *out = sms * per_sm;
  return (int)err;
}

// A whole factorization in place in `state`. `tabs`: sched, piv_addr,
// piv_dlane, piv_dst, n_piv, push_off, push_src, push_dst, wait; `cfg`:
// n_sup, D, MPD, srows, s_loc, R, W, MP, n_bands, p_max; flags: D unsigned
// ints of scratch. staged: 1 when the ring fits in shared memory (the
// wrapper decides), else 0 and the bands are factored in place.
extern "C" int superstep_factor_persistent_launch(const void* const* tabs, const int* cfg,
                                                  void* state, void* flags, int staged,
                                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Factor F;
  F.state = (float*)state;
  F.sched = (const int*)tabs[0];
  F.piv_addr = (const int*)tabs[1];
  F.piv_dlane = (const int*)tabs[2];
  F.piv_dst = (const int*)tabs[3];
  F.n_piv = (const int*)tabs[4];
  F.push_off = (const int*)tabs[5];
  F.push_src = (const int*)tabs[6];
  F.push_dst = (const int*)tabs[7];
  F.wait = (const int*)tabs[8];
  F.flags = (unsigned*)flags;
  F.n_sup = cfg[0], F.n_owners = cfg[1], F.mpd = cfg[2], F.srows = cfg[3], F.s_loc = cfg[4];
  F.R = cfg[5], F.W = cfg[6], F.MP = cfg[7], F.n_bands = cfg[8], F.p_max = cfg[9];
  const size_t smem = persistent_smem(cfg, staged);
  cudaError_t err = persistent_prepare(staged, smem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(flags, 0, (size_t)F.n_owners * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&F};
  const void* kernel = staged ? (const void*)superstep_factor_persistent_kernel<true>
                              : (const void*)superstep_factor_persistent_kernel<false>;
  return (int)cudaLaunchCooperativeKernel(kernel, dim3(F.n_owners), dim3(32 * F.mpd), args,
                                          smem, st);
}

// flags: n_owners unsigned ints of scratch; sink: one float.
extern "C" int superstep_factor_chain_floor_launch(int n_owners, int n_sup, int chain,
                                                   void* flags, void* sink, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flags, 0, (size_t)n_owners * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;
  unsigned* f = (unsigned*)flags;
  float* out = (float*)sink;
  void* args[] = {&n_sup, &chain, &n_owners, &f, &out};
  return (int)cudaLaunchCooperativeKernel((const void*)superstep_factor_chain_floor_kernel,
                                          dim3(n_owners), dim3(32), args, 0, st);
}
