// C <- C - A B for Hopper (sm_90a): one product, or all of one pivot's
// products of a Block-ILU(k) tile pool in one launch.
//
// Replaces the Pallas kernel `panel_update` in
// src/repro/kernels/panel_update.py (the trailing-tile update of the
// Block-ILU(k) numeric phase, A_JT -= L_JI U_IT): the product is computed
// in this kernel's own body, as the Pallas kernel computes it in its.
//
// Shapes: A (M, K), B (K, N), C and the output (M, N), all row-major, with
// M, N and K any sizes (the ragged edge is masked here, where the JAX
// wrapper pads). The output may be C itself: every thread reads the C
// entries it owns before it writes them, and no other thread touches them.
// It must not overlap A or B (the wrapper checks).
//
// Two bodies:
//
// * float32 (panel_update_kernel), on the CUDA cores only: TF32 would
//   change the result. Each output's sum runs over k ascending, one
//   __fmaf_rn per term, from +0.0; then out = __fsub_rn(c, sum). The tiling
//   below keeps that chain (no split of k), so every tiling gives the same
//   bits. The Pallas kernel sums in blocks of 128 along k with the MXU's
//   own order, and the plain version (torch's matrix product) in yet
//   another, so the three agree to a tolerance of order
//   K * 2^-24 * (|C| + |A||B|), not bitwise.
// * bfloat16 (panel_update_mma_kernel), the Pallas kernel's bf16 form: bf16
//   inputs on the tensor cores (mma.sync m16n8k16, float32 accumulation),
//   then out = bf16(__fsub_rn(c, sum)), one rounding to nearest. The tensor
//   cores' order of adds is their own: held to a tolerance.
//
// The grouped form (panel_update_slots_launch, float32): products p of a
// (T, bs, bs) pool, pool[dst[p]] -= pool[l[p]] pool[u[p]], one launch,
// blockIdx.y = p, through the same float32 body, so every dst equals the
// single call's output bitwise. Within one launch no product may read a
// tile that another writes: the dst slots ascend strictly (so they are
// distinct) and none is an l or u slot of the list. Each block checks its
// own product before it touches a tile (every slot inside the pool, dst
// above the dst before it) and, while its first loads are in flight, that
// its dst is no l or u slot of the list (O(products) per block); a block
// whose check fails traps, so a bad list ends in a launch error, never in
// a write past the pool or a race.
//
// Bound: a (128, 128)^2 product does 4.2 MFLOP and moves 256 KB, about
// 0.06 us at 67 TFLOP/s (float32, CUDA cores) and 0.08 us at 3.35 TB/s;
// one pivot's 16 products at bs = 128 do 67 MFLOP (1.0 us) and move about
// 2.6 MB (0.78 us). The work is small for the card: a single product must
// spread over many SMs, and one pivot's grid should fill a wave of them.
// Design (float32): 32 x 32 output blocks of 64 threads, each thread a
// 4 x 4 register tile (rows ty + 8i, columns 4tx..4tx+3); k staged 64 at a
// time through shared memory by cp.async (16-byte copies when rows are
// 16-byte aligned, else 4-byte ones), double buffered; A kept row-major
// (A[row][k], row stride 68 floats) and B as it is (B[k][col], 36), so the
// float4 reads of one warp fall in distinct bank quads; 16 blocks per
// (128, 128) product, 256 for a pivot of 16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 32
#define BN 32
#define BK 64
#define THREADS 64
#define LDA (BK + 4)  // row stride of the staged A, in floats
#define LDB (BN + 4)  // row stride of the staged B, in floats

__device__ __forceinline__ unsigned to_smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 or 4 bytes from src to dst, or zeros when !valid (src is then not read)
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(to_smem(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void copy4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to_smem(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// Stage k0..k0+BK of A's rows row0.. and B's columns col0.. into as/bs.
template <bool VEC>
__device__ __forceinline__ void stage(float* as, float* bs, const float* a, const float* b,
                                      int m, int n, int k, int row0, int col0, int k0) {
  if (VEC) {  // k and n multiples of 4, operands 16-byte aligned
#pragma unroll
    for (int q = 0; q < BM * BK / 4 / THREADS; ++q) {
      const int e = threadIdx.x + q * THREADS, r = e / (BK / 4), kc = e % (BK / 4) * 4;
      const bool ok = row0 + r < m && k0 + kc < k;
      copy16(as + r * LDA + kc, ok ? a + (size_t)(row0 + r) * k + k0 + kc : a, ok);
    }
#pragma unroll
    for (int q = 0; q < BK * BN / 4 / THREADS; ++q) {
      const int e = threadIdx.x + q * THREADS, r = e / (BN / 4), cc = e % (BN / 4) * 4;
      const bool ok = k0 + r < k && col0 + cc < n;
      copy16(bs + r * LDB + cc, ok ? b + (size_t)(k0 + r) * n + col0 + cc : b, ok);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < BM * BK / THREADS; ++q) {
      const int e = threadIdx.x + q * THREADS, r = e / BK, kc = e % BK;
      const bool ok = row0 + r < m && k0 + kc < k;
      copy4(as + r * LDA + kc, ok ? a + (size_t)(row0 + r) * k + k0 + kc : a, ok);
    }
#pragma unroll 4
    for (int q = 0; q < BK * BN / THREADS; ++q) {
      const int e = threadIdx.x + q * THREADS, r = e / BN, cc = e % BN;
      const bool ok = k0 + r < k && col0 + cc < n;
      copy4(bs + r * LDB + cc, ok ? b + (size_t)(k0 + r) * n + col0 + cc : b, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The float32 body. Single form: `dst` null, the operands as given, one
// product (gridDim.y = 1). Grouped form: product blockIdx.y of the lists,
// in the pool at `c` (= a = b = out), tiles of m x m floats.
template <bool VEC>
__global__ void __launch_bounds__(THREADS)
panel_update_kernel(const float* c, const float* a, const float* b, float* out, int m, int n,
                    int k, const int* __restrict__ l_slots, const int* __restrict__ u_slots,
                    const int* __restrict__ dst, int n_tiles, int n_products) {
  __shared__ __align__(16) float as[2][BM * LDA];
  __shared__ __align__(16) float bs[2][BK * LDB];
  int slot = -1;
  if (dst) {
    const int p = blockIdx.y, ls = l_slots[p], us = u_slots[p];
    slot = dst[p];
    if (ls < 0 || ls >= n_tiles || us < 0 || us >= n_tiles || slot < 0 || slot >= n_tiles ||
        (p > 0 && dst[p - 1] >= slot))
      __trap();
    const size_t tile = (size_t)m * m;
    a = c + ls * tile;
    b = c + us * tile;
    out = const_cast<float*>(c) + slot * tile;
    c = out;
  }
  const int nbn = (n + BN - 1) / BN;
  const int row0 = blockIdx.x / nbn * BM, col0 = blockIdx.x % nbn * BN;
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  const int nk = (k + BK - 1) / BK;
  stage<VEC>(as[0], bs[0], a, b, m, n, k, row0, col0, 0);
  if (dst) {  // no product of the list may read the tile this one writes
    int bad = 0;
    for (int q = threadIdx.x; q < n_products; q += THREADS)
      bad |= l_slots[q] == slot || u_slots[q] == slot;
    if (__syncthreads_or(bad)) __trap();
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      stage<VEC>(as[(t + 1) & 1], bs[(t + 1) & 1], a, b, m, n, k, row0, col0, (t + 1) * BK);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* sa = as[t & 1];
    const float* sb = bs[t & 1];
    const int kmax = min(BK, k - t * BK);  // the zero padding never enters a sum
    int kk = 0;
    for (; kk + 4 <= kmax; kk += 4) {
      float av[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(sa + (ty + 8 * i) * LDA + kk);
        av[i][0] = v.x, av[i][1] = v.y, av[i][2] = v.z, av[i][3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const float4 v = *reinterpret_cast<const float4*>(sb + (kk + s) * LDB + tx * 4);
        const float bv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i][s], bv[j], acc[i][j]);
      }
    }
    for (; kk < kmax; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = sa[(ty + 8 * i) * LDA + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av, sb[kk * LDB + tx * 4 + j], acc[i][j]);
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 8 * i, col = col0 + tx * 4;
    if (r >= m) continue;
    const size_t at = (size_t)r * n + col;
    if (VEC && col < n) {
      const float4 cv = *reinterpret_cast<const float4*>(c + at);
      *reinterpret_cast<float4*>(out + at) =
          make_float4(__fsub_rn(cv.x, acc[i][0]), __fsub_rn(cv.y, acc[i][1]),
                      __fsub_rn(cv.z, acc[i][2]), __fsub_rn(cv.w, acc[i][3]));
    } else if (!VEC) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < n) out[at + j] = __fsub_rn(c[at + j], acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores: 32 x 32 output blocks of 4 warps, each warp
// a 16 x 16 patch as two m16n8k16 products per 16 of k; k staged 128 at a
// time (all of it at bs = 128), A row-major and B transposed (Bt[col][k])
// in shared memory, so that each fragment register is one aligned 32-bit
// read of two bf16 along k. VEC: 16-byte loads of 8 bf16 (k and n
// multiples of 8, operands 16-byte aligned), else one bf16 at a time.
#define HB 32    // output block side
#define HBK 128  // k per stage
#define HLD (HBK + 8)

__device__ __forceinline__ uint32_t pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool VEC>
__global__ void __launch_bounds__(128)
panel_update_mma_kernel(const __nv_bfloat16* c, const __nv_bfloat16* __restrict__ a,
                        const __nv_bfloat16* __restrict__ b, __nv_bfloat16* out, int m, int n,
                        int k) {
  __shared__ __align__(16) __nv_bfloat16 as[HB * HLD];  // as[r * HLD + kk] = A[row0 + r, k0 + kk]
  __shared__ __align__(16) __nv_bfloat16 bt[HB * HLD];  // bt[cc * HLD + kk] = B[k0 + kk, col0 + cc]
  const int nbn = (n + HB - 1) / HB;
  const int row0 = blockIdx.x / nbn * HB, col0 = blockIdx.x % nbn * HB;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wr = warp / 2 * 16, wc = warp % 2 * 16;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);
  float acc[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
  for (int k0 = 0; k0 < k; k0 += HBK) {
    if (VEC) {
      for (int e = threadIdx.x; e < HB * HBK / 8; e += 128) {
        const int r = e / (HBK / 8), kc = e % (HBK / 8) * 8;  // A: 8 bf16 along a row
        uint4 v = make_uint4(0, 0, 0, 0);
        if (row0 + r < m && k0 + kc < k)
          v = *reinterpret_cast<const uint4*>(a + (size_t)(row0 + r) * k + k0 + kc);
        *reinterpret_cast<uint4*>(as + r * HLD + kc) = v;
        const int kb = e / (HB / 8), cc = e % (HB / 8) * 8;  // B: 8 columns of one k
        uint4 w = make_uint4(0, 0, 0, 0);
        if (k0 + kb < k && col0 + cc < n)
          w = *reinterpret_cast<const uint4*>(b + (size_t)(k0 + kb) * n + col0 + cc);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&w);
#pragma unroll
        for (int i = 0; i < 8; ++i) bt[(cc + i) * HLD + kb] = h[i];
      }
    } else {
      for (int e = threadIdx.x; e < HB * HBK; e += 128) {
        const int r = e / HBK, kk = e % HBK;  // consecutive threads along a row of A
        as[r * HLD + kk] =
            (row0 + r < m && k0 + kk < k) ? a[(size_t)(row0 + r) * k + k0 + kk] : zero;
        const int kb = e / HB, cc = e % HB;  // consecutive threads along a row of B
        bt[cc * HLD + kb] =
            (k0 + kb < k && col0 + cc < n) ? b[(size_t)(k0 + kb) * n + col0 + cc] : zero;
      }
    }
    __syncthreads();
    const int kmax = min(HBK, k - k0);  // zero padding past k adds exact zeros
    for (int ks = 0; ks < kmax; ks += 16) {
      const __nv_bfloat16* ar = as + (wr + g) * HLD + ks + 2 * t4;
      const uint32_t a0 = pair(ar), a1 = pair(ar + 8 * HLD), a2 = pair(ar + 8),
                     a3 = pair(ar + 8 * HLD + 8);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const __nv_bfloat16* br = bt + (wc + nt * 8 + g) * HLD + ks + 2 * t4;
        const uint32_t b0 = pair(br), b1 = pair(br + 8);
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[nt][0]), "+f"(acc[nt][1]), "+f"(acc[nt][2]), "+f"(acc[nt][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + wr + g + (e / 2) * 8, col = col0 + wc + nt * 8 + 2 * t4 + e % 2;
      if (r < m && col < n) {
        const size_t at = (size_t)r * n + col;
        out[at] = __float2bfloat16_rn(__fsub_rn(__bfloat162float(c[at]), acc[nt][e]));
      }
    }
}

static bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// bf16 != 0: every operand and the output are bfloat16; else float32.
extern "C" int panel_update_launch(const void* c, const void* a, const void* b, void* out,
                                   int m, int n, int k, int bf16, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    const dim3 grid(((n + HB - 1) / HB) * ((m + HB - 1) / HB));
    const auto ca = (const __nv_bfloat16*)c, aa = (const __nv_bfloat16*)a,
               ba = (const __nv_bfloat16*)b;
    if (k % 8 == 0 && n % 8 == 0 && aligned16(a) && aligned16(b))
      panel_update_mma_kernel<true><<<grid, 128, 0, s>>>(ca, aa, ba, (__nv_bfloat16*)out, m, n, k);
    else
      panel_update_mma_kernel<false><<<grid, 128, 0, s>>>(ca, aa, ba, (__nv_bfloat16*)out, m, n,
                                                          k);
    return (int)cudaGetLastError();
  }
  const dim3 grid(((n + BN - 1) / BN) * ((m + BM - 1) / BM));
  const bool vec = k % 4 == 0 && n % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c) &&
                   aligned16(out);
  if (vec)
    panel_update_kernel<true><<<grid, THREADS, 0, s>>>((const float*)c, (const float*)a,
                                                       (const float*)b, (float*)out, m, n, k,
                                                       nullptr, nullptr, nullptr, 0, 0);
  else
    panel_update_kernel<false><<<grid, THREADS, 0, s>>>((const float*)c, (const float*)a,
                                                        (const float*)b, (float*)out, m, n, k,
                                                        nullptr, nullptr, nullptr, 0, 0);
  return (int)cudaGetLastError();
}

// One pivot's products on a float32 pool of n_tiles (bs, bs) tiles:
// pool[dst[p]] -= pool[l[p]] pool[u[p]] for p < n_products, in one launch.
extern "C" int panel_update_slots_launch(void* pool, const void* l_slots, const void* u_slots,
                                         const void* dst, int n_tiles, int n_products, int bs,
                                         void* stream) {
  const dim3 grid(((bs + BN - 1) / BN) * ((bs + BM - 1) / BM), n_products);
  const float* p = (const float*)pool;
  if (bs % 4 == 0 && aligned16(pool))
    panel_update_kernel<true><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        p, p, p, (float*)pool, bs, bs, bs, (const int*)l_slots, (const int*)u_slots,
        (const int*)dst, n_tiles, n_products);
  else
    panel_update_kernel<false><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        p, p, p, (float*)pool, bs, bs, bs, (const int*)l_slots, (const int*)u_slots,
        (const int*)dst, n_tiles, n_products);
  return (int)cudaGetLastError();
}
