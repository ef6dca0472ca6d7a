// Round-major pivot-op ILU(k) numeric factorization, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `factor_wavefront` in
// src/repro/kernels/panel_update.py, whose body is
// repro.core.numeric_jax.factor_wavefront_sweeps_jnp.
//
// Per op t of a round (reduce row j against pivot row i at lane p):
//   l = x[j,p] / x[i,dlane];  x[j,dst[t,q]] -= rn(l * x[i,q]) for q = 0..W-1;
//   x[j,p] = l
// with __fdiv_rn, __fmul_rn and __fsub_rn, in the reference's order. Lane
// dst == W is dropped. Pad ops (row == n) are skipped: in the reference
// they only rewrite the zero scratch row with itself.
//
// Why it may update in place: the ops of one round reduce distinct rows,
// and every pivot row they read finished in an earlier round (the schedule
// makes op (j,p) wait on the last op of its pivot row). So within a round no
// thread writes a row that another thread reads.
//
// Bound: the chain of rounds, not bytes. The work is a few MB, but the NR
// rounds depend on each other, so the time is NR times one round's latency.
// Design: the rounds are a chain, so one launch loops over them with a
// barrier between rounds. A round's time is set by its memory requests as
// much as by their latency: a round reads some 600 scattered rows and
// writes 300, and one SM serves about one cache line a cycle. So the round
// is spread over a cluster of CLUSTER blocks on as many SMs, and the
// barrier between rounds is the cluster's hardware barrier (release and
// acquire at cluster scope); rows are read through L2 (ld.global.cg), so
// no block reads a stale line of a row another block wrote. An op is
// worked by a group of G = 8, 16 or 32 threads (G >= W), thread e holding
// entry e of the rows: a row is one coalesced request of the group. Each
// group takes 4 ops of a round at once, their loads all in flight together.
// Each op is packed in one int4 {j, i, p | dlane << 16, dst row}
// (ops.pack_factor_schedule), and its lane entries are laid out by (round,
// slot) beside it (ops.factor_lane_slots: G int8 per op), so that neither
// load depends on the other. The schedule does not depend on the values,
// so it is staged ahead: each block's group leaders copy the op words and
// lane entries of the round three rounds ahead into a ring of four rounds
// in shared memory by cp.async, which holds no register (a load into
// registers a round ahead was sunk to its use by the compiler). A round's
// chain so holds one trip to L2: thread e loads x[j,e] and x[i,e], takes
// x[j,p], x[i,dlane] and the pivot entry its lane subtracts by shuffles
// within the group, computes l = x[j,p] / x[i,dlane] and its update, and
// stores its entry, l at lane p. The lane entry is the dst map inverted
// per op (src[e] = the pivot lane q with dst[q] = e, or -1;
// ops.invert_dst_lanes, built once per plan): a row's lanes are its
// distinct columns, so each lane takes at most one update, and the order
// of updates across lanes cannot change a bit. The host refuses a plan
// whose dst map repeats a lane. A row wider than 32 lanes is updated in
// place in device memory by one thread per op of one block, through the
// dst map in the reference's order (the WIDE kernel). The values stay in
// device memory: 4.5 MB on the main path is L2-resident and too large for
// shared memory.
#include <cuda_runtime.h>

#define MAX_THREADS 1024
#define CLUSTER 8  // blocks of the round loop, on as many SMs
#define FULL_MASK 0xffffffffu
#define OPS_PER_GROUP 4  // ops per group and pass

__device__ __forceinline__ int4 load_op(const int4* __restrict__ ops, size_t at, bool live,
                                        int n) {
  return live ? ops[at] : make_int4(n, n, 0, 0);
}

// Lane e's entry of slot t of round r (-1: no update, a pad op, or past W).
template <int G>
__device__ __forceinline__ int lane_of(const signed char* __restrict__ lanes, int r, int t,
                                       bool live, int max_ops, int e) {
  return live ? lanes[((size_t)r * max_ops + t) * G + e] : -1;
}

// OPS_PER_GROUP ops, one per slot, each by its group of G threads (thread
// e: entry e).
template <int G>
__device__ __forceinline__ void apply_ops(const int4* op, const int* src, float* x, int n, int w,
                                          int e) {
  float row[OPS_PER_GROUP], piv[OPS_PER_GROUP];
#pragma unroll
  for (int k = 0; k < OPS_PER_GROUP; ++k) {
    const bool live = op[k].x < n && e < w;
    row[k] = live ? __ldcg(x + (size_t)op[k].x * w + e) : 0.0f;
    piv[k] = live ? __ldcg(x + (size_t)op[k].y * w + e) : 0.0f;
  }
#pragma unroll
  for (int k = 0; k < OPS_PER_GROUP; ++k) {
    const int p = op[k].z & 0xffff, dl = op[k].z >> 16;
    const float xp = __shfl_sync(FULL_MASK, row[k], p, G);
    const float pd = __shfl_sync(FULL_MASK, piv[k], dl, G);
    const float pq = __shfl_sync(FULL_MASK, piv[k], src[k] < 0 ? 0 : src[k], G);
    const float l = __fdiv_rn(xp, op[k].x < n ? pd : 1.0f);
    float v = src[k] >= 0 ? __fsub_rn(row[k], __fmul_rn(l, pq)) : row[k];
    v = e == p ? l : v;
    if (op[k].x < n && e < w) x[(size_t)op[k].x * w + e] = v;
  }
}

#define STAGES 4  // rounds of the schedule in the shared-memory ring

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void commit_async() { asm volatile("cp.async.commit_group;\n"); }

// Wait until at most STAGES - 2 copy groups of this thread are pending.
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
}

// Every thread of the cluster: what each wrote before is seen by all after.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int G>
__global__ void __launch_bounds__(MAX_THREADS)
factor_wavefront_kernel(const int4* __restrict__ ops, const signed char* __restrict__ lanes,
                        float* x, int n_rounds, int max_ops, int n, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = threadIdx.x % G, g = threadIdx.x / G, groups = blockDim.x / G;
  // group gg of the cluster's all_groups takes slots gg, gg + all_groups, ...
  const int all_groups = groups * gridDim.x, gg = blockIdx.x * groups + g;
  // the ops of a round one pass takes; a fuller round runs further passes
  const int per_pass = all_groups * OPS_PER_GROUP;
  const int mine = groups * OPS_PER_GROUP;  // this block's ring slots per round
  int4* ring_ops = reinterpret_cast<int4*>(smem);  // [STAGES][mine] op words
  signed char* ring_lanes = reinterpret_cast<signed char*>(ring_ops + STAGES * mine);
  // round s's first-pass slots of this block into its ring: each group
  // leader copies its ops' words and lane entries; every thread commits one
  // group a round
  auto stage = [&](int s) {
    if (e == 0 && s < n_rounds) {
      const int at = (s % STAGES) * mine;
#pragma unroll
      for (int k = 0; k < OPS_PER_GROUP; ++k) {
        const int t = gg + k * all_groups;
        if (t >= max_ops) break;
        const size_t from = (size_t)s * max_ops + t;
        copy_async<16>(ring_ops + at + g + k * groups, ops + from);
        signed char* to = ring_lanes + (size_t)(at + g + k * groups) * G;
        if constexpr (G == 8) {
          copy_async<8>(to, lanes + from * G);
        } else {
#pragma unroll
          for (int b = 0; b < G; b += 16) copy_async<16>(to + b, lanes + from * G + b);
        }
      }
    }
    commit_async();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage(s);
  wait_async();
  cluster_sync();
  for (int r = 0; r < n_rounds; ++r) {
    stage(r + STAGES - 1);  // into the ring slot round r - 1 left
    int4 op[OPS_PER_GROUP];
    int src[OPS_PER_GROUP];
    const int at = (r % STAGES) * mine;
#pragma unroll
    for (int k = 0; k < OPS_PER_GROUP; ++k) {
      const bool live = gg + k * all_groups < max_ops;
      const int slot = at + g + k * groups;
      op[k] = live ? ring_ops[slot] : make_int4(n, n, 0, 0);
      src[k] = live ? ring_lanes[(size_t)slot * G + e] : -1;
    }
    apply_ops<G>(op, src, x, n, w, e);
    for (int base = per_pass; base < max_ops; base += per_pass) {
      int4 more[OPS_PER_GROUP];
      int msrc[OPS_PER_GROUP];
#pragma unroll
      for (int k = 0; k < OPS_PER_GROUP; ++k) {
        const int t = base + gg + k * all_groups;
        more[k] = load_op(ops, (size_t)r * max_ops + t, t < max_ops, n);
        msrc[k] = lane_of<G>(lanes, r, t, t < max_ops, max_ops, e);
      }
      apply_ops<G>(more, msrc, x, n, w, e);
    }
    wait_async();  // round r + 1's slots, for the whole block after the barrier
    cluster_sync();
  }
}

// W > 32: one thread per op, the row updated in place in device memory by
// the reference's walk over q through the dst map.
__global__ void __launch_bounds__(MAX_THREADS)
factor_wavefront_wide_kernel(const int4* __restrict__ ops, const int* __restrict__ dst_flat,
                             float* x, int n_rounds, int max_ops, int n, int w) {
  for (int r = 0; r < n_rounds; ++r) {
    for (int t = threadIdx.x; t < max_ops; t += blockDim.x) {
      const int4 op = ops[(size_t)r * max_ops + t];
      if (op.x >= n) continue;
      float* xj = x + (size_t)op.x * w;
      const float* xi = x + (size_t)op.y * w;
      const int* dst = dst_flat + (size_t)op.w * w;
      const float l = __fdiv_rn(xj[op.z & 0xffff], xi[op.z >> 16]);
      for (int q = 0; q < w; ++q) {
        const int d = dst[q];
        if (d < w) xj[d] = __fsub_rn(xj[d], __fmul_rn(l, xi[q]));
      }
      xj[op.z & 0xffff] = l;
    }
    __syncthreads();
  }
}

// The chain floor: the factor kernel's cluster, threads and round loop
// with, per round, one dependent L2 load, the divide and the cluster
// barrier, and nothing else.
__global__ void __launch_bounds__(MAX_THREADS)
factor_wavefront_chain_floor_kernel(const float* zeros, int n_rounds, float* sink) {
  float v = 0.0f;
  for (int r = 0; r < n_rounds; ++r) {
    const float g = __ldcg(zeros + threadIdx.x + (__float_as_int(v) & 1));
    v = __fdiv_rn(g, 3.0f + v);
    cluster_sync();
  }
  if (v != 0.0f) *sink = v;
}

static int group_of(int w) { return w <= 8 ? 8 : w <= 16 ? 16 : w <= 32 ? 32 : 0; }

// Threads of one block of the launch (of CLUSTER blocks for w <= 32, one
// block above) for max_ops ops a round of rows of w lanes.
extern "C" int factor_wavefront_threads(int max_ops, int w) {
  const int g = group_of(w);
  const long groups = ((long)(max_ops + OPS_PER_GROUP - 1) / OPS_PER_GROUP + CLUSTER - 1) / CLUSTER;
  const long want = g ? groups * g : max_ops;
  const long t = ((want + 31) / 32) * 32;
  return t < 32 ? 32 : t > MAX_THREADS ? MAX_THREADS : (int)t;
}

// Launch `kernel` as one cluster of CLUSTER blocks of `threads`.
template <typename... Params, typename... Args>
static cudaError_t launch_cluster(void (*kernel)(Params...), int threads, size_t smem,
                                  cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ops: (n_rounds, max_ops) int4; dst_flat: (n_ops+1, w) int (the WIDE
// kernel's); lanes: (n_rounds, max_ops, G) int8 lane entries (w <= 32,
// G = 8, 16 or 32 >= w; may be null above); x: (n+1, w) values factored in
// place.
extern "C" int factor_wavefront_launch(const void* ops, const void* dst_flat, const void* lanes,
                                       void* x, int n_rounds, int max_ops, int n, int w,
                                       void* stream) {
  const int4* o = (const int4*)ops;
  const signed char* ln = (const signed char*)lanes;
  float* xv = (float*)x;
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = factor_wavefront_threads(max_ops, w);
  const int g = group_of(w);
  if (g && !ln) return (int)cudaErrorInvalidValue;
  // a block's ring: at most 4 * 512 * (16 + 8) = 48 KB (G = 8), 32 KB (16), 24 KB (32)
  const size_t ring = g ? (size_t)STAGES * (threads / g) * OPS_PER_GROUP * (16 + g) : 0;
  cudaError_t err = cudaSuccess;
  if (g == 8)
    err = launch_cluster(factor_wavefront_kernel<8>, threads, ring, s, o, ln, xv, n_rounds,
                         max_ops, n, w);
  else if (g == 16)
    err = launch_cluster(factor_wavefront_kernel<16>, threads, ring, s, o, ln, xv, n_rounds,
                         max_ops, n, w);
  else if (g == 32)
    err = launch_cluster(factor_wavefront_kernel<32>, threads, ring, s, o, ln, xv, n_rounds,
                         max_ops, n, w);
  else
    factor_wavefront_wide_kernel<<<1, threads, 0, s>>>(o, (const int*)dst_flat, xv, n_rounds,
                                                       max_ops, n, w);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// `zeros`: threads + 1 floats of 0; `sink`: one float.
extern "C" int factor_wavefront_chain_floor_launch(int n_rounds, int threads, const void* zeros,
                                                   void* sink, void* stream) {
  const cudaError_t err = launch_cluster(factor_wavefront_chain_floor_kernel, threads, 0,
                                        (cudaStream_t)stream, (const float*)zeros, n_rounds,
                                        (float*)sink);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
