// Hopper (sm_90a) int8 tensor-core building blocks shared by the packed
// segment-min scans of adc_scan.cu and ivf_scan.cu (and, for its layout
// and its uint8 product, the tree descent of vocab_descend.cu).
//
// A block is one warpgroup (128 threads) that owns 128 database rows for
// the whole query batch. The rows sit K-major in shared memory in the
// 128-byte swizzled layout wgmma reads (K in 128-byte panels; the 16-byte
// chunk c of row r at c ^ (r & 7)). Tiles of 64
// queries stream through a ring of NST (3, or 2 where 3 do not fit in
// 227 KB) such tiles, loaded by cp.async NST - 1 tiles ahead. Each query
// tile is one wgmma.mma_async m64n128k32 s32.s8.s8 per 32 bytes of D per
// row tile, the queries as A and the rows as B, both read from shared
// memory through descriptors; D is zero-padded to a multiple of 32 (zeros
// add nothing to an integer sum). The epilogue stays in registers: a
// thread's accumulators hold 2 queries against 32 rows (2 of each 8-row
// chunk), so the per-segment minimum of acc * SEG + col[row] is taken over
// those, then over the 4 lanes of a quad by two shuffles, and handed to
// the kernel's epilogue, which stores it. An int8 x int8 -> int32 sum is
// exact in any order, so the tensor cores give the plain twins' bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper_int8 {

constexpr int ROWS = 128;     // database rows per row tile: the wgmma N
constexpr int QT = 64;        // queries per tile: the wgmma M
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 3;     // query tiles in flight, where they fit
constexpr int PANEL = 128;    // K bytes per swizzled panel (one swizzle row)
constexpr size_t SMEM_OPTIN = 227 * 1024;  // sm_90's per-block opt-in

__host__ __device__ constexpr int n_panels(int d) {
  return (d + PANEL - 1) / PANEL;
}
__host__ __device__ constexpr int n_ksteps(int d) { return (d + 31) / 32; }
__host__ __device__ constexpr size_t rows_bytes(int d) {
  return (size_t)n_panels(d) * ROWS * PANEL;
}
__host__ __device__ constexpr size_t qtile_bytes(int d) {
  return (size_t)n_panels(d) * QT * PANEL;
}

// Byte k of row r in a tile of `rows` K-major rows laid out as wgmma's
// 128-byte swizzle reads it: K in panels of 128 bytes, each panel `rows`
// rows of 128 bytes, the 16-byte chunk c of row r stored at c ^ (r & 7).
__device__ __forceinline__ int swz(int r, int k, int rows) {
  return (k >> 7) * rows * PANEL + r * PANEL +
         ((((k >> 4) & 7) ^ (r & 7)) << 4) + (k & 15);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// wgmma shared-memory descriptor of a K-major, 128-byte swizzled operand:
// start address, leading offset 1 (unused by swizzled K-major layouts),
// 1,024 bytes between 8-row groups, swizzle mode 1 (128 bytes).
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (+)= a (64 x 32, K-major) * b (128 x 32, K-major)^T, int8 in (signed
// for wgmma_s8, unsigned for wgmma_u8), int32 out; accumulate = 0
// overwrites d
#define HOPPER_INT8_WGMMA(NAME, TYPES)                                      \
  __device__ __forceinline__ void NAME(int (&d)[64], uint64_t da,          \
                                       uint64_t db, int accumulate) {      \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                       \
        "wgmma.mma_async.sync.aligned.m64n128k32.s32." TYPES " {"          \
        "%0, %1, %2, %3, %4, %5, %6, %7, "                                 \
        "%8, %9, %10, %11, %12, %13, %14, %15, "                           \
        "%16, %17, %18, %19, %20, %21, %22, %23, "                         \
        "%24, %25, %26, %27, %28, %29, %30, %31, "                         \
        "%32, %33, %34, %35, %36, %37, %38, %39, "                         \
        "%40, %41, %42, %43, %44, %45, %46, %47, "                         \
        "%48, %49, %50, %51, %52, %53, %54, %55, "                         \
        "%56, %57, %58, %59, %60, %61, %62, %63 "                          \
        "}, %64, %65, p;\n}\n"                                             \
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),                  \
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),                  \
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),                \
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),              \
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),              \
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),              \
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),              \
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),              \
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),              \
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),              \
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),              \
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),              \
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),              \
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),              \
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),              \
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])               \
        : "l"(da), "l"(db), "r"(accumulate));                              \
  }

HOPPER_INT8_WGMMA(wgmma_s8, "s8.s8")
HOPPER_INT8_WGMMA(wgmma_u8, "u8.u8")
#undef HOPPER_INT8_WGMMA

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from touching the accumulators across the wait
__device__ __forceinline__ void reg_fence(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// makes this thread's shared-memory writes visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Zero bytes [d, 32 n_ksteps(d)) of every row of the row tile and of the
// nst query tiles (the last k-step reads them); nothing writes them again.
__device__ __forceinline__ void zero_k_pad(int8_t* rows_s, int8_t* q_s,
                                           int d, int nst) {
  const int pad = n_ksteps(d) * 32 - d;
  if (pad == 0) return;
  for (int i = threadIdx.x; i < (ROWS + nst * QT) * pad; i += THREADS) {
    const int r = i / pad, k = d + (i - r * pad);
    if (r < ROWS) {
      rows_s[swz(r, k, ROWS)] = 0;
    } else {
      const int st = (r - ROWS) / QT;
      q_s[st * qtile_bytes(d) + swz(r - ROWS - st * QT, k, QT)] = 0;
    }
  }
}

// 16-byte query copies need 16-byte rows and a 16-byte aligned batch.
inline bool vec16_ok(const void* q2s, int d) {
  return d % 16 == 0 && reinterpret_cast<uintptr_t>(q2s) % 16 == 0;
}

// Queue the copy of queries q0 .. q0 + QT ([QT, d] bytes of q2s) into a
// swizzled query tile: 16-byte cp.async where rows and pointer allow,
// else 4-byte.
__device__ __forceinline__ void load_q_tile(int8_t* dst,
                                            const int8_t* __restrict__ q2s,
                                            int q0, int d, bool vec16) {
  const int8_t* src = q2s + (size_t)q0 * d;
  const int w = vec16 ? 16 : 4, cpr = d / w;
  for (int i = threadIdx.x; i < QT * cpr; i += THREADS) {
    const int r = i / cpr, k = (i - r * cpr) * w;
    if (vec16)
      cp_async16(dst + swz(r, k, QT), src + (size_t)r * d + k);
    else
      cp_async4(dst + swz(r, k, QT), src + (size_t)r * d + k);
  }
}

// Queue the ring's first NST - 1 query tiles (one cp.async group each), as
// score_block expects on entry; nq = bpad / QT tiles in all.
template <int NST>
__device__ __forceinline__ void q_ring_prologue(int8_t* q_s,
                                                const int8_t* __restrict__ q2s,
                                                int nq, int d, bool vec16) {
#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nq) load_q_tile(q_s + s * qtile_bytes(d), q2s, s * QT, d, vec16);
    cp_async_commit();
  }
}

// Turn the [d, ROWS] int8 block at src (row stride ld bytes: a column
// block of an N-major [d, N] cache) into ROWS swizzled K-major rows by
// 4 x 4 byte transposes: a thread reads one word (4 rows) of each of 4
// dims, coalesced along the rows, and writes one word (4 dims) of each of
// those rows. A thread loads up to 8 such groups before it stores any, so
// their latencies overlap. d % 4 == 0, src and ld 4-byte aligned.
__device__ __forceinline__ void transpose_rows(int8_t* rows_s,
                                               const int8_t* __restrict__ src,
                                               size_t ld, int d) {
  constexpr int BATCH = 8;
  const int n = (ROWS / 4) * (d / 4);
  const size_t lw = ld / 4;
  for (int p0 = threadIdx.x; p0 < n; p0 += BATCH * THREADS) {
    unsigned w[BATCH][4];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int p = p0 + u * THREADS;
      if (p < n) {
        const int rg = p & (ROWS / 4 - 1), jg = p / (ROWS / 4);
        const unsigned* s = reinterpret_cast<const unsigned*>(
            src + (size_t)(4 * jg) * ld + 4 * rg);
        w[u][0] = s[0];
        w[u][1] = s[lw];
        w[u][2] = s[2 * lw];
        w[u][3] = s[3 * lw];
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int p = p0 + u * THREADS;
      if (p < n) {
        const int rg = p & (ROWS / 4 - 1), jg = p / (ROWS / 4);
        const unsigned lo01 = __byte_perm(w[u][0], w[u][1], 0x5140);
        const unsigned hi01 = __byte_perm(w[u][0], w[u][1], 0x7362);
        const unsigned lo23 = __byte_perm(w[u][2], w[u][3], 0x5140);
        const unsigned hi23 = __byte_perm(w[u][2], w[u][3], 0x7362);
        const unsigned rows4[4] = {__byte_perm(lo01, lo23, 0x5410),
                                   __byte_perm(lo01, lo23, 0x7632),
                                   __byte_perm(hi01, hi23, 0x5410),
                                   __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<unsigned*>(rows_s + swz(4 * rg + i, 4 * jg,
                                                    ROWS)) = rows4[i];
      }
    }
  }
}

// Scores the block's row tile (rows_s, swizzled K-major; key base column
// col_s, ROWS entries) against every query, the ring's first tiles
// already queued (q_ring_prologue). Segment s of the tile (ROWS / SEG of
// them) and query q give the minimum key v, which epi.store receives with
// the (segment, query) pair's Epi::Tile value: epi.load(t) fetches those
// of query tile t, one tile ahead of its use, so their latency hides
// behind a tile of products; the caller passes tile 0's (`next`), loaded
// as early as it likes. The pairs of a thread's quad are spread over its
// 4 lanes (pair p by lane p % 4), so a lane loads and stores at most a
// quarter of them.
// COL_REGS keeps a thread's 32 entries of the key base column in
// registers: the ADC scans (128 query tiles per block) take it, and lose
// ~5% with the column read from shared memory (PERF.md, PR 5 R1). false
// reads them from shared memory at each use, which frees those registers
// for a fourth block per SM: the IVF scan (a few query tiles per block).
template <int SEG, int NST, bool COL_REGS, class Epi>
__device__ void score_block(const int8_t* rows_s, int8_t* q_s,
                            const int* col_s, const int8_t* __restrict__ q2s,
                            int bpad, int d, bool vec16, const Epi& epi,
                            typename Epi::Tile next) {
  constexpr int NS = ROWS / SEG;   // segments per row tile
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int nk = n_ksteps(d), nq = bpad / QT;
  const size_t qb = qtile_bytes(d);
  // the thread's rows of each 8-row n-chunk j: 8 j + 2 tig + e
  int col[16][2];
  if constexpr (COL_REGS) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) col[j][e] = col_s[8 * j + 2 * tig + e];
  }

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  for (int t = 0; t < nq; ++t) {
    cp_async_wait<NST - 2>();
    fence_async_smem();
    __syncthreads();  // tile t has landed; every warp is done with t - 1
    const int nt = t + NST - 1;
    if (nt < nq) load_q_tile(q_s + (nt % NST) * qb, q2s, nt * QT, d, vec16);
    cp_async_commit();
    const typename Epi::Tile cur = next;
    if (t + 1 < nq) next = epi.load(t + 1);

    const int8_t* qt = q_s + (t % NST) * qb;
    // acc[4 j + 2 h + e] is query 16 warp + g + 8 h against row
    // 8 j + 2 tig + e of the row tile; an 8-row chunk lies in one segment
    const size_t q = (size_t)t * QT + 16 * warp + g;
    wgmma_fence();
    for (int kk = 0; kk < nk; ++kk) {
      const int ka = (kk >> 2) * QT * PANEL + (kk & 3) * 32;
      const int kb = (kk >> 2) * ROWS * PANEL + (kk & 3) * 32;
      wgmma_s8(acc, make_desc(qt + ka), make_desc(rows_s + kb), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int mn[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) mn[s] = INT32_MAX;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int s = (8 * j) / SEG;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = COL_REGS ? col[j][e] : col_s[8 * j + 2 * tig + e];
          mn[s] = min(mn[s], acc[4 * j + 2 * h + e] * SEG + c);
        }
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        int v = min(mn[s], __shfl_xor_sync(0xffffffffu, mn[s], 1));
        v = min(v, __shfl_xor_sync(0xffffffffu, v, 2));
        const int p = 2 * s + h;
        if (tig == (p & 3)) epi.store(cur, p >> 2, s, q + 8 * h, v);
      }
    }
  }
}

// The ADC kernels' epilogue: the minimum key is the output.
struct SegStore {
  struct Tile {};
  int32_t* segpack;
  size_t seg0;  // the block's first segpack row
  int bpad;
  __device__ __forceinline__ Tile load(int) const { return {}; }
  __device__ __forceinline__ void store(const Tile&, int, int s, size_t q,
                                        int v) const {
    segpack[(seg0 + s) * bpad + q] = v;
  }
};

// Opens smem bytes of dynamic shared memory to kernel and launches it on
// `blocks` blocks of THREADS threads.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), size_t smem, int blocks, cudaStream_t st,
           A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace hopper_int8
