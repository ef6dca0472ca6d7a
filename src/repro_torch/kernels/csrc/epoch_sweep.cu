// The band-partitioned triangular sweep, for Hopper (sm_90a): every epoch of
// the L and the U sweep of one preconditioner apply, exchanges included, in
// one persistent launch over D band owners and nb right-hand sides.
//
// Replaces the Pallas kernel `epoch_sweep` in
// src/repro/kernels/tri_sweep_epoch.py, whose body is
// repro.core.triangular.epoch_sweep_jnp: the compute an owner performs
// between two exchanges of the distributed sweep. On the TPU each exchange
// is a collective between the epochs; here all D owners live on one card,
// so an exchange is a copy inside device memory and runs in the kernel.
//
// Layout: owner d's sweep vector for right-hand side `lane` is
// x[d][lane][0 .. xlen), laid out [local slots | ingress halo | scratch]
// (scratch = `limit`). The level tables cols/vals are (D, nlev, maxr, W)
// with owner-local dependency addresses (padding -> `limit`); diag is
// (D, nlev, maxr), or null for the unit-diagonal L sweep. Row r of level l
// writes slot s = l*maxr + r,
//     y = rhs - acc            (L)
//     y = (rhs - acc) / diag   (U, __fdiv_rn)
// with acc the level body shared with tri_solve_wavefront.cu
// (level_row_sum, level_row.cuh): lanes at or past `limit` are skipped.
// Every slot of every level is written, pad rows included, as the
// reference's dynamic_update_slice does. The right-hand side of slot s is
// rhs[d*rhs_owner + lane*rhs_lane + idx] with idx = rhs_idx[d][s] (s when
// rhs_idx is null); an idx at or past rhs_len reads +0.0 (the reference's
// zero pad). The L sweep reads b this way (owner stride 0), the U sweep the
// owner's own L output, and the per-epoch entry a materialized rhs.
//
// Exchanges: ex_after[l] = k + 1 when exchange k follows level l (the last
// level of an epoch whose read set is non-empty), else 0. Exchange k's
// payload tables start at ex_off[k] (E_k = ex_off[k+1] - ex_off[k]
// entries per owner): eg[D*ex_off[k] + s*E_k + e] is the local address of
// sender s's entry e, ing[D*D*ex_off[k] + (r*D + s)*E_k + e] where receiver
// r files it (at or past `limit`: r does not read it). After the epoch's
// levels, owner d publishes that it finished exchange ex_base + k + 1 with
// a release store of its flag; every owner then acquires the flag of each
// other owner and PULLS the entries it reads into its own halo. The U
// sweep also writes each real row's value into the output (out_row), which
// is the replicated vector the reference assembles from its exchanges.
//
// Why one wait per exchange suffices, and no grid barrier: an egress slot
// is a local slot (< n_loc) of the level that produced it; a sender writes
// each local slot once per sweep and never again, so a slot a receiver
// pulls after acquiring the flag is final and no later write of the sender
// can race it. A receiver writes only its own halo, each halo slot once
// per sweep (a foreign slot ships once, in the epoch that produced it),
// and no block reads another owner's halo. A receiver reads a halo slot
// only in an epoch after the exchange that fills it, and it waited for that
// exchange before its next epoch. All owners run the same epochs in the
// same order and publish before they wait, so no wait can deadlock. Every
// block must be resident: the launch is cooperative, and refused when D
// blocks do not fit the card. A wait is bounded and ends in __trap(), so a
// fault in the protocol ends in a launch error, never in a hang. The flags
// are zeroed on the stream before the launch, so no count of an earlier
// apply carries over.
//
// Bound: the chain of levels and exchanges, not bytes. An epoch of the
// natural ordering holds one or two levels of at most 50 rows per owner, so
// an apply moves a few MB; its time is about 2,400 epochs of one level's
// dependent loads, a barrier, a release, an acquire and a pull. Design: one
// block per owner whose threads stride over (right-hand side, row), so nb
// right-hand sides need no more blocks; the per-epoch entry
// (epoch_sweep_launch, no exchange) runs the same kernel over one range of
// levels.
#include <cuda_runtime.h>

#include "level_row.cuh"

#define SPIN_LIMIT (1ll << 24)  // polls of a flag before a wait traps (seconds)

struct Sweep {
  float* x;
  const int* cols;
  const float* vals;
  const float* diag;
  const float* rhs;
  const int* rhs_idx;
  long long rhs_owner, rhs_lane;
  int rhs_len;
  const int* ex_after;
  const int* ex_off;
  const int* eg;
  const int* ing;
  int ex_base;
  const int* out_row;
  float* out;
  int n_out;
  int nlev, maxr, w, xlen, limit, lo, hi;
};

__device__ __forceinline__ unsigned load_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// Each thread acquires the flags of owners threadIdx.x, threadIdx.x +
// blockDim.x, ... (all but d) until they reach `count`; a bounded wait.
__device__ __forceinline__ void wait_for_owners(const unsigned* flags, unsigned count, int d,
                                                int n_owners) {
  for (int s = threadIdx.x; s < n_owners; s += blockDim.x) {
    if (s == d) continue;
    long long polls = 0;
    while (load_acquire_gpu(flags + s) < count)
      if (++polls > SPIN_LIMIT) __trap();
  }
}

// Publish that this owner finished exchange `count`, wait for every other
// owner to do the same, then pull the entries this owner reads.
__device__ void exchange(const Sweep& S, int k, int d, int n_owners, int nb, unsigned* flags) {
  const unsigned count = (unsigned)(S.ex_base + k + 1);
  if (threadIdx.x == 0) {
    __threadfence();
    store_release_gpu(flags + d, count);
  }
  wait_for_owners(flags, count, d, n_owners);
  __syncthreads();
  const int off = S.ex_off[k], e_k = S.ex_off[k + 1] - off;
  const int* eg = S.eg + (size_t)n_owners * off;
  const int* ing = S.ing + (size_t)n_owners * n_owners * off + (size_t)d * n_owners * e_k;
  const int per_lane = n_owners * e_k;
  for (int t = threadIdx.x; t < nb * per_lane; t += blockDim.x) {
    const int lane = t / per_lane, se = t % per_lane, s = se / e_k;
    const int to = ing[se];
    if (s == d || to >= S.limit) continue;
    const float* src = S.x + ((size_t)s * nb + lane) * S.xlen;
    S.x[((size_t)d * nb + lane) * S.xlen + to] = __ldcg(src + eg[se]);
  }
  __syncthreads();
}

__device__ void run_sweep(const Sweep& S, int d, int n_owners, int nb, unsigned* flags) {
  const size_t tab = (size_t)d * S.nlev * S.maxr;  // owner d's first (level, rank) row
  const int rows = nb * S.maxr;
  for (int lev = S.lo; lev < S.hi; ++lev) {
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      const int lane = t / S.maxr;
      const size_t s = (size_t)lev * S.maxr + t % S.maxr;
      float* xv = S.x + ((size_t)d * nb + lane) * S.xlen;
      // the row's right-hand side and output row first, so that their
      // loads are in flight with the level sum's gathers
      const int idx = S.rhs_idx ? S.rhs_idx[tab + s] : (int)s;
      const int o = S.out_row ? S.out_row[tab + s] : S.n_out;
      const float r = idx < S.rhs_len
                          ? S.rhs[d * S.rhs_owner + lane * S.rhs_lane + idx]
                          : 0.0f;
      const float acc = level_row_sum(S.cols + (tab + s) * S.w, S.vals + (tab + s) * S.w, xv,
                                      S.w, S.limit, S.limit);
      float y = __fsub_rn(r, acc);
      if (S.diag) y = __fdiv_rn(y, S.diag[tab + s]);
      xv[s] = y;
      if (o < S.n_out) S.out[(size_t)lane * S.n_out + o] = y;
    }
    __syncthreads();
    const int k = S.ex_after ? S.ex_after[lev] : 0;
    if (k > 0) exchange(S, k - 1, d, n_owners, nb, flags);
  }
}

// Block d runs owner d's levels of the first sweep, then of the second.
__global__ void epoch_sweep_kernel(Sweep first, Sweep second, int n_sweeps, int n_owners,
                                   int nb, unsigned* flags) {
  const int d = blockIdx.x;
  run_sweep(first, d, n_owners, nb, flags);
  if (n_sweeps > 1) run_sweep(second, d, n_owners, nb, flags);
}

// The chain floor: per epoch one dependent L2 load, a barrier, a release, an
// acquire of every other owner's flag and a barrier, and nothing else.
__global__ void epoch_sweep_chain_floor_kernel(const float* zeros, int n_epochs, int n_owners,
                                               unsigned* flags, float* sink) {
  const int d = blockIdx.x;
  float v = 0.0f;
  for (int e = 0; e < n_epochs; ++e) {
    if (threadIdx.x == 0) v = __ldcg(zeros + (__float_as_int(v) & 1));
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      store_release_gpu(flags + d, (unsigned)(e + 1));
    }
    wait_for_owners(flags, (unsigned)(e + 1), d, n_owners);
    __syncthreads();
  }
  if (threadIdx.x == 0 && v != 0.0f) *sink = v;
}

static int threads_for(int rows) {
  int t = ((rows + 31) / 32) * 32;
  return t < 32 ? 32 : t > 1024 ? 1024 : t;
}

// The most owners (blocks of `threads`) the current device holds resident at
// once: the cooperative launch refuses more.
extern "C" int epoch_sweep_max_owners(int threads, int* out) {
  int dev, sms, per_sm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, epoch_sweep_kernel, threads, 0);
  *out = err == cudaSuccess ? sms * per_sm : 0;
  return (int)err;
}

static cudaError_t launch(Sweep first, Sweep second, int n_sweeps, int n_owners, int nb,
                          unsigned* flags, cudaStream_t stream) {
  const int rows = nb * (n_sweeps > 1 && second.maxr > first.maxr ? second.maxr : first.maxr);
  if (flags) {
    cudaError_t err = cudaMemsetAsync(flags, 0, (size_t)n_owners * sizeof(unsigned), stream);
    if (err != cudaSuccess) return err;
  }
  void* args[] = {&first, &second, &n_sweeps, &n_owners, &nb, &flags};
  return cudaLaunchCooperativeKernel((const void*)epoch_sweep_kernel, dim3(n_owners),
                                     dim3(threads_for(rows)), args, 0, stream);
}

// The per-epoch entry: levels [lo, hi) of one sweep over the materialized
// rhs (D, nb, nlev, maxr), no exchange.
extern "C" int epoch_sweep_launch(void* x, const void* cols, const void* vals, const void* rhs,
                                  const void* diag, int n_owners, int nb, int nlev, int maxr,
                                  int w, int xlen, int lo, int hi, int limit, void* stream) {
  Sweep S = {};
  S.x = (float*)x;
  S.cols = (const int*)cols;
  S.vals = (const float*)vals;
  S.diag = (const float*)diag;
  S.rhs = (const float*)rhs;
  S.rhs_owner = (long long)nb * nlev * maxr;
  S.rhs_lane = (long long)nlev * maxr;
  S.rhs_len = nlev * maxr;
  S.nlev = nlev, S.maxr = maxr, S.w = w, S.xlen = xlen, S.limit = limit, S.lo = lo, S.hi = hi;
  return (int)launch(S, S, 1, n_owners, nb, nullptr, (cudaStream_t)stream);
}

// One whole apply: the L sweep over b (nb, rhs_len_l) and the U sweep over
// the owner's own L output, into out (nb, n_out). `tabs` holds per sweep
// (L, then U) the pointers cols, vals, diag, rhs_idx, ex_after, ex_off, eg,
// ing, out_row; `cfg` per sweep nlev, maxr, w, xlen, limit, rhs_len,
// ex_base; then n_owners, n_out. flags: n_owners unsigned ints of scratch.
extern "C" int epoch_sweep_apply_launch(const void* const* tabs, const int* cfg, const void* b,
                                        void* x_l, void* x_u, void* out, void* flags, int nb,
                                        void* stream) {
  const int n_owners = cfg[14], n_out = cfg[15];
  Sweep sw[2] = {};
  float* xs[2] = {(float*)x_l, (float*)x_u};
  for (int i = 0; i < 2; ++i) {
    const void* const* t = tabs + 9 * i;
    const int* c = cfg + 7 * i;
    Sweep& S = sw[i];
    S.x = xs[i];
    S.cols = (const int*)t[0];
    S.vals = (const float*)t[1];
    S.diag = (const float*)t[2];
    S.rhs_idx = (const int*)t[3];
    S.ex_after = (const int*)t[4];
    S.ex_off = (const int*)t[5];
    S.eg = (const int*)t[6];
    S.ing = (const int*)t[7];
    S.out_row = (const int*)t[8];
    S.nlev = c[0], S.maxr = c[1], S.w = c[2], S.xlen = c[3], S.limit = c[4];
    S.rhs_len = c[5], S.ex_base = c[6];
    S.lo = 0, S.hi = c[0];
  }
  sw[0].rhs = (const float*)b;  // replicated: every owner reads the same b
  sw[0].rhs_owner = 0;
  sw[0].rhs_lane = sw[0].rhs_len;
  sw[1].rhs = (const float*)x_l;  // the owner's own L output
  sw[1].rhs_owner = (long long)nb * sw[0].xlen;
  sw[1].rhs_lane = sw[0].xlen;
  sw[1].out = (float*)out;
  sw[1].n_out = n_out;
  return (int)launch(sw[0], sw[1], 2, n_owners, nb, (unsigned*)flags, (cudaStream_t)stream);
}

// `zeros`: at least two floats of 0; `sink`: one float; `flags`: n_owners
// unsigned ints of scratch.
extern "C" int epoch_sweep_chain_floor_launch(int n_owners, int n_epochs, int threads,
                                              const void* zeros, void* flags, void* sink,
                                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(flags, 0, (size_t)n_owners * sizeof(unsigned), s);
  if (err != cudaSuccess) return (int)err;
  const float* z = (const float*)zeros;
  unsigned* f = (unsigned*)flags;
  float* out = (float*)sink;
  void* args[] = {&z, &n_epochs, &n_owners, &f, &out};
  return (int)cudaLaunchCooperativeKernel((const void*)epoch_sweep_chain_floor_kernel,
                                          dim3(n_owners), dim3(threads), args, 0, s);
}
