// Packed segment-min ADC scan kernels for Hopper (sm_90a), scored on the
// int8 tensor cores.
//
// Replace the two Pallas TPU kernels of cvt_tpu/ops/pallas/adc_scan.py:
//   adc_segmin_kernel        <- _adc_segmin_kernel        (launched by _adc_segmin)
//   adc_segmin_cached_kernel <- _adc_segmin_cached_kernel (launched by _adc_segmin_cached)
// tiletop_kernel derives each tile's best-two output from the segment
// minima for both.
//
// What they compute, per database row r and query b:
//   dec_r     = int8 decode of r's PQ codes (gather from int8 codebooks) or
//               the pre-decoded cache column
//   ip        = <dec_r, q2s_b>               exact int32 (int8 tensor cores)
//   norm_i    = clip(rint(norm_r / qs), 0, vcap), or ibase for r >= n_valid
//   key       = ip * SEG + norm_i * SEG + (r % SEG)
// and emit min(key) over each SEG-row segment (segpack [Npad/SEG, Bpad]),
// plus each tile's two best keys and their rows-in-tile (tiletop
// [n_tiles, 8, Bpad], rows 4-7 zero). The bounds of _pack_caps keep every
// key inside int32, so the signed arithmetic below never overflows, and an
// int8 x int8 -> int32 sum is exact in any order, so the tensor cores give
// the plain twin's bits.
//
// What bounds it on the H100: int8 operations, 2*Npad*D*B = 2.1e12 per
// batch at Npad = 1M, D = 128, B = 8192, 1.08 ms at the 1,979 TOP/s int8
// tensor-core peak. Bytes are small beside that: codes 8 MB (or the
// decoded cache 128 MB), the queries 1 MB, segpack ~260 MB written
// (~0.12 ms at 3.35 TB/s). Second to the products comes the epilogue: one
// shift-add and one min per (row, query), 8.3e9 outputs per batch on the
// CUDA cores (~1 ms at 64 int32 lanes per SM per clock), and the 1 MB query
// batch that every 128-row block streams through L2 (8 GB per batch).
//
// What this design does about it: one block (one warpgroup, 128 threads)
// owns 128 rows for the whole query batch, so each row is decoded (or
// transposed) once, into a K-major [128, D] int8 tile in shared memory, in
// the 128-byte swizzled layout wgmma reads (K in 128-byte panels; the
// 16-byte chunk c of row r at c ^ (r & 7)). Tiles of 64 queries stream
// through a ring of three such tiles, loaded by cp.async two tiles ahead
// (two tiles, one ahead, where three do not fit in 227 KB: the cached
// kernel at 640 < D <= 896, which the int32 keys allow at SEG <= 64; the
// decode kernel's codebooks share the query region, which caps it at
// D <= 580 for k_sub = 256).
// Each tile is one wgmma.mma_async m64n128k32 s32.s8.s8 per 32 bytes of D,
// the queries as A and the rows as B, both read from shared memory through
// descriptors; D is zero-padded to a multiple of 32 (zeros add nothing to
// an integer sum). The epilogue stays in registers: a thread's
// accumulators hold 2 queries against 32 rows (2 of each 8-row chunk), so
// the per-segment minimum of acc * SEG + col[row] is taken over those,
// then over the 4 lanes of a quad by two shuffles, and stored. Only segpack
// leaves the block. Four blocks share an SM (128 registers, 50 KB of
// shared memory each: the decode kernel's codebooks use the query ring
// until the decode ends).
//
// Segment sizes. SEG in {128, 64, 32, 16, 8} is a template parameter: a
// block holds 128 / SEG segments, and an 8-row chunk of the accumulators
// always lies in one of them.
//
// Exactness rules: norm / qs is IEEE division (__fdiv_rn) and rintf rounds
// half to even like jnp.round; the float32 norm is summed in one fixed
// order (row_norm), the PyTorch twin's, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;     // database rows per block: the wgmma N
constexpr int QT = 64;        // queries per tile: the wgmma M
constexpr int THREADS = 128;  // one warpgroup
constexpr int STAGES = 3;     // query tiles in flight, where they fit
constexpr int PANEL = 128;    // K bytes per swizzled panel (one swizzle row)
constexpr int IMAX = 2147000000;
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
// The region of nst query tiles; the decode kernel's codebooks (cb bytes)
// share it until the decode ends.
__host__ __device__ constexpr size_t qregion_bytes(int d, size_t cb,
                                                   int nst) {
  return nst * qtile_bytes(d) > cb ? nst * qtile_bytes(d)
                                   : (cb + 15) / 16 * 16;
}
// Dynamic shared memory of one block: 1,024 bytes of alignment slack, the
// row tile, the query region and the key base column.
__host__ inline size_t smem_bytes(int d, size_t cb, int nst) {
  return 1024 + rows_bytes(d) + qregion_bytes(d, cb, nst) +
         ROWS * sizeof(int);
}
// Query tiles in flight, a kernel template parameter: STAGES where they
// fit, else 2 (the wrapper rejects shapes where 2 do not fit either).
__host__ inline int n_stages(int d, size_t cb) {
  return smem_bytes(d, cb, STAGES) <= SMEM_OPTIN ? STAGES : 2;
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

// wgmma shared-memory descriptor of a K-major, 128-byte swizzled operand:
// start address, leading offset 1 (unused by swizzled K-major layouts),
// 1,024 bytes between 8-row groups, swizzle mode 1 (128 bytes).
__device__ __forceinline__ uint64_t make_desc(const void* p) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (+)= a (64 x 32, K-major) * b (128 x 32, K-major)^T, signed int8 in,
// int32 out; accumulate = 0 overwrites d
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

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

template <int SEG>
__device__ __forceinline__ int key_base(float norm, float qs, bool valid,
                                        int vcap, int ibase, int lane) {
  float x = rintf(__fdiv_rn(norm, qs));
  x = fminf(fmaxf(x, 0.0f), (float)vcap);
  return (valid ? (int)x : ibase) * SEG + lane;
}

// sum_d row[d]^2 * s2[d] over row r of the row tile, in the twin's order
// (_row_norms): 32 interleaved FMA accumulators, lanes combined
// ((0-7 + 8-15) + 16-23) + 24-31, then halved 8 -> 4 -> 2 -> 1.
__device__ __forceinline__ float row_norm(const int8_t* rows_s, int r,
                                          const float* __restrict__ s2,
                                          int d) {
  float a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = 0.0f;
  for (int d0 = 0; d0 < d; d0 += 32) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (d0 + j < d) {
        const float v = (float)rows_s[swz(r, d0 + j, ROWS)];
        a[j] = __fmaf_rn(v * v, s2[d0 + j], a[j]);
      }
    }
  }
  float v[8];
#pragma unroll
  for (int l = 0; l < 8; ++l)
    v[l] = __fadd_rn(__fadd_rn(__fadd_rn(a[l], a[l + 8]), a[l + 16]),
                     a[l + 24]);
#pragma unroll
  for (int l = 0; l < 4; ++l) v[l] = __fadd_rn(v[l], v[l + 4]);
#pragma unroll
  for (int l = 0; l < 2; ++l) v[l] = __fadd_rn(v[l], v[l + 2]);
  return __fadd_rn(v[0], v[1]);
}

// Zero bytes [d, 32 n_ksteps(d)) of every row of the row tile and of the
// query tiles (the last k-step reads them); nothing writes them again.
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

// Scores the block's ROWS rows (rows_s, swizzled K-major, with its key
// base column col_s) against every query, writing the block's ROWS / SEG
// segment minima per query into segpack rows seg0 .. seg0 + ROWS / SEG.
// q_s is a ring of NST (2 or 3) query tiles.
template <int SEG, int NST>
__device__ void score_block(const int8_t* rows_s, int8_t* q_s,
                            const int* col_s, const int8_t* __restrict__ q2s,
                            int bpad, int d, bool vec16,
                            int32_t* __restrict__ segpack, size_t seg0) {
  constexpr int NS = ROWS / SEG;   // segments per block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int nk = n_ksteps(d), nq = bpad / QT;
  const size_t qb = qtile_bytes(d);
  // the thread's rows of each 8-row n-chunk j: 8 j + 2 tig + e
  int col[16][2];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) col[j][e] = col_s[8 * j + 2 * tig + e];

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    if (s < nq) load_q_tile(q_s + s * qb, q2s, s * QT, d, vec16);
    cp_async_commit();
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

    const int8_t* qt = q_s + (t % NST) * qb;
    wgmma_fence();
    for (int kk = 0; kk < nk; ++kk) {
      const int ka = (kk >> 2) * QT * PANEL + (kk & 3) * 32;
      const int kb = (kk >> 2) * ROWS * PANEL + (kk & 3) * 32;
      wgmma_s8(acc, make_desc(qt + ka), make_desc(rows_s + kb), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(acc);

    // acc[4 j + 2 h + e] is query 16 warp + g + 8 h against row
    // 8 j + 2 tig + e; an 8-row chunk lies in one segment
    const size_t q = (size_t)t * QT + 16 * warp + g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int mn[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) mn[s] = INT32_MAX;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int s = (8 * j) / SEG;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mn[s] = min(mn[s], acc[4 * j + 2 * h + e] * SEG + col[j][e]);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        int v = min(mn[s], __shfl_xor_sync(0xffffffffu, mn[s], 1));
        v = min(v, __shfl_xor_sync(0xffffffffu, v, 2));
        if (tig == 0) segpack[(seg0 + s) * bpad + q + 8 * h] = v;
      }
    }
  }
}

// ds bytes of one codeword from shared memory into row r of the swizzled
// row tile at K offset k0 (zeros for a code past k_sub, as a one-hot
// product would give), in the widest copies ds allows.
__device__ __forceinline__ void copy_codeword(int8_t* rows_s, int r, int k0,
                                              const int8_t* src, int ds,
                                              bool valid) {
  if ((ds & 15) == 0) {
    for (int t = 0; t < ds; t += 16)
      *reinterpret_cast<int4*>(rows_s + swz(r, k0 + t, ROWS)) =
          valid ? *reinterpret_cast<const int4*>(src + t)
                : make_int4(0, 0, 0, 0);
  } else if ((ds & 3) == 0) {
    for (int t = 0; t < ds; t += 4)
      *reinterpret_cast<int*>(rows_s + swz(r, k0 + t, ROWS)) =
          valid ? *reinterpret_cast<const int*>(src + t) : 0;
  } else {
    for (int t = 0; t < ds; ++t)
      rows_s[swz(r, k0 + t, ROWS)] = valid ? src[t] : 0;
  }
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// grid.x = Npad / ROWS, THREADS threads. Dynamic shared memory:
// smem_bytes(d, k_sub * d, NST), the int8 codebooks [m, k_sub, ds] staged
// in the query region until the decode ends.
template <int SEG, int NST>
__global__ void __launch_bounds__(THREADS)
adc_segmin_kernel(const uint8_t* __restrict__ codes,
                  const int8_t* __restrict__ cb_q,
                  const int8_t* __restrict__ q2s,
                  const float* __restrict__ s2, const float* __restrict__ qs,
                  int m, int k_sub, int ds, int bpad, int n_valid, int vcap,
                  int ibase, bool vec16, int32_t* __restrict__ segpack) {
  extern __shared__ unsigned char smem_raw[];
  const int d = m * ds;
  int8_t* rows_s = reinterpret_cast<int8_t*>(align1024(smem_raw));
  int8_t* q_s = rows_s + rows_bytes(d);
  int8_t* cb_s = q_s;
  int* col_s = reinterpret_cast<int*>(
      q_s + qregion_bytes(d, (size_t)k_sub * d, NST));
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * ROWS;

  // stage the codebooks (k_sub * d bytes, d % 4 == 0)
  const int cb_words = k_sub * d / 4;
  for (int i = tid; i < cb_words; i += THREADS)
    reinterpret_cast<int*>(cb_s)[i] = reinterpret_cast<const int*>(cb_q)[i];
  __syncthreads();

  // decode by shared-memory gather into the swizzled row tile: one (row,
  // subspace) pair per step, consecutive threads on consecutive subspaces
  for (int p = tid; p < ROWS * m; p += THREADS) {
    const int r = p / m, mm = p - r * m;
    const int code = codes[(row0 + r) * m + mm];
    copy_codeword(rows_s, r, mm * ds,
                  cb_s + ((size_t)mm * k_sub + min(code, k_sub - 1)) * ds, ds,
                  code < k_sub);
  }
  __syncthreads();  // the codebooks are dead: the query tiles take them over
  zero_k_pad(rows_s, q_s, d, NST);
  // row0 is a multiple of ROWS, so tid % SEG is the row's lane
  col_s[tid] = key_base<SEG>(row_norm(rows_s, tid, s2, d), *qs,
                             row0 + tid < (size_t)n_valid, vcap, ibase,
                             tid & (SEG - 1));
  fence_async_smem();
  __syncthreads();
  score_block<SEG, NST>(rows_s, q_s, col_s, q2s, bpad, d, vec16, segpack,
                        (size_t)blockIdx.x * (ROWS / SEG));
}

// grid.x = Npad / ROWS; dec8_t [d, npad] int8, norm_col [npad] f32.
template <int SEG, int NST>
__global__ void __launch_bounds__(THREADS)
adc_segmin_cached_kernel(const int8_t* __restrict__ dec8_t,
                         const float* __restrict__ norm_col,
                         const int8_t* __restrict__ q2s,
                         const float* __restrict__ qs, int npad, int d,
                         int bpad, int n_valid, int vcap, int ibase,
                         bool vec16, int32_t* __restrict__ segpack) {
  extern __shared__ unsigned char smem_raw[];
  int8_t* rows_s = reinterpret_cast<int8_t*>(align1024(smem_raw));
  int8_t* q_s = rows_s + rows_bytes(d);
  int* col_s = reinterpret_cast<int*>(q_s + qregion_bytes(d, 0, NST));
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * ROWS;

  zero_k_pad(rows_s, q_s, d, NST);
  // turn the [d, ROWS] block of the N-major cache into K-major rows by
  // 4 x 4 byte transposes: a thread reads one word (4 rows) of each of 4
  // dims, coalesced along the rows, and writes one word (4 dims) of each
  // of those rows
  const int npw = npad / 4;
  for (int p = tid; p < (ROWS / 4) * (d / 4); p += THREADS) {
    const int rg = p & (ROWS / 4 - 1), jg = p / (ROWS / 4);
    const int* src = reinterpret_cast<const int*>(
        dec8_t + (size_t)(4 * jg) * npad + row0 + 4 * rg);
    const unsigned w0 = src[0], w1 = src[npw], w2 = src[2 * npw],
                   w3 = src[3 * npw];
    const unsigned lo01 = __byte_perm(w0, w1, 0x5140);  // a0 b0 a1 b1
    const unsigned hi01 = __byte_perm(w0, w1, 0x7362);  // a2 b2 a3 b3
    const unsigned lo23 = __byte_perm(w2, w3, 0x5140);  // c0 d0 c1 d1
    const unsigned hi23 = __byte_perm(w2, w3, 0x7362);  // c2 d2 c3 d3
    const unsigned rows4[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<unsigned*>(rows_s + swz(4 * rg + i, 4 * jg, ROWS)) =
          rows4[i];
  }
  col_s[tid] = key_base<SEG>(norm_col[row0 + tid], *qs,
                             row0 + tid < (size_t)n_valid, vcap, ibase,
                             tid & (SEG - 1));
  fence_async_smem();
  __syncthreads();
  score_block<SEG, NST>(rows_s, q_s, col_s, q2s, bpad, d, vec16, segpack,
                        (size_t)blockIdx.x * (ROWS / SEG));
}

// grid (n_tiles, bpad / 128), 128 threads: one (tile, query) per thread.
// Same selection as the TPU kernel: m1 = best key, r1 its first segment;
// m2 = best key once every segment equal to m1 is masked to IMAX, r2 the
// first segment holding m2 after masking. Rows-in-tile are r * seg plus
// the key's lane, key & (seg - 1) (seg a power of two: exact for negative
// keys in two's complement).
__global__ void tiletop_kernel(const int32_t* __restrict__ segpack, int spt,
                               int seg, int bpad,
                               int32_t* __restrict__ tiletop) {
  const int b = blockIdx.y * blockDim.x + threadIdx.x;
  const int32_t* col = segpack + (size_t)blockIdx.x * spt * bpad + b;
  int m1 = INT32_MAX;
  for (int s = 0; s < spt; ++s) m1 = min(m1, col[(size_t)s * bpad]);
  int r1 = spt, m2 = INT32_MAX;
  for (int s = 0; s < spt; ++s) {
    const int p = col[(size_t)s * bpad];
    if (p == m1 && r1 == spt) r1 = s;
    m2 = min(m2, p == m1 ? IMAX : p);
  }
  int r2 = spt;
  for (int s = 0; s < spt; ++s) {
    const int p = col[(size_t)s * bpad];
    if ((p == m1 ? IMAX : p) == m2) { r2 = s; break; }
  }
  int32_t* out = tiletop + (size_t)blockIdx.x * 8 * bpad + b;
  out[0] = m1;
  out[(size_t)bpad] = m2;
  out[(size_t)2 * bpad] = r1 * seg + (m1 & (seg - 1));
  out[(size_t)3 * bpad] = r2 * seg + (m2 & (seg - 1));
  for (int r = 4; r < 8; ++r) out[(size_t)r * bpad] = 0;
}

int launch_tiletop(const int32_t* segpack, int npad, int bpad, int tile_n,
                   int seg, int32_t* tiletop, cudaStream_t st) {
  dim3 grid(npad / tile_n, bpad / 128);
  tiletop_kernel<<<grid, 128, 0, st>>>(segpack, tile_n / seg, seg, bpad,
                                       tiletop);
  return (int)cudaGetLastError();
}

// 16-byte query copies need 16-byte rows and a 16-byte aligned batch.
bool vec16_ok(const void* q2s, int d) {
  return d % 16 == 0 && reinterpret_cast<uintptr_t>(q2s) % 16 == 0;
}

// Opens smem bytes of dynamic shared memory to kernel and launches it on
// npad / ROWS blocks.
template <typename... P, typename... A>
int launch(void (*kernel)(P...), size_t smem, int npad, cudaStream_t st,
           A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<npad / ROWS, THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int SEG>
int launch_segmin(const void* codes, const void* cb_q, const void* q2s,
                  const void* s2, const void* qs, int npad, int m, int k_sub,
                  int ds, int bpad, int n_valid, int vcap, int ibase,
                  void* segpack, cudaStream_t st) {
  const int d = m * ds;
  const size_t cb = (size_t)k_sub * d;
  const int nst = n_stages(d, cb);
  return launch(nst == STAGES ? adc_segmin_kernel<SEG, STAGES>
                              : adc_segmin_kernel<SEG, 2>,
                smem_bytes(d, cb, nst), npad, st,
                static_cast<const uint8_t*>(codes),
                static_cast<const int8_t*>(cb_q),
                static_cast<const int8_t*>(q2s),
                static_cast<const float*>(s2), static_cast<const float*>(qs),
                m, k_sub, ds, bpad, n_valid, vcap, ibase, vec16_ok(q2s, d),
                static_cast<int32_t*>(segpack));
}

template <int SEG>
int launch_segmin_cached(const void* dec8_t, const void* norm_col,
                         const void* q2s, const void* qs, int npad, int d,
                         int bpad, int n_valid, int vcap, int ibase,
                         void* segpack, cudaStream_t st) {
  const int nst = n_stages(d, 0);
  return launch(nst == STAGES ? adc_segmin_cached_kernel<SEG, STAGES>
                              : adc_segmin_cached_kernel<SEG, 2>,
                smem_bytes(d, 0, nst), npad, st,
                static_cast<const int8_t*>(dec8_t),
                static_cast<const float*>(norm_col),
                static_cast<const int8_t*>(q2s),
                static_cast<const float*>(qs), npad, d, bpad, n_valid, vcap,
                ibase, vec16_ok(q2s, d), static_cast<int32_t*>(segpack));
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (Bpad % 128 == 0, D % 4 == 0,
// seg in {128, 64, 32, 16, 8}, tile_n % seg == 0, Npad % tile_n == 0,
// Npad % 128 == 0, contiguous 4-byte-aligned tensors, the block's shared
// memory at two query stages within SMEM_OPTIN). Returns 0 or the
// cudaError_t of the failed call.
int cvt_adc_segmin(const void* codes, const void* cb_q, const void* q2s,
                   const void* s2, const void* qs, int npad, int m,
                   int k_sub, int ds, int bpad, int n_valid, int tile_n,
                   int seg, int vcap, int ibase, void* segpack,
                   void* tiletop, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e;
  switch (seg) {
#define CVT_SEGMIN(S)                                                       \
  case S:                                                                   \
    e = launch_segmin<S>(codes, cb_q, q2s, s2, qs, npad, m, k_sub, ds, bpad, \
                         n_valid, vcap, ibase, segpack, st);                \
    break;
    CVT_SEGMIN(128) CVT_SEGMIN(64) CVT_SEGMIN(32) CVT_SEGMIN(16) CVT_SEGMIN(8)
#undef CVT_SEGMIN
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  return launch_tiletop(static_cast<const int32_t*>(segpack), npad, bpad,
                        tile_n, seg, static_cast<int32_t*>(tiletop), st);
}

int cvt_adc_segmin_cached(const void* dec8_t, const void* norm_col,
                          const void* q2s, const void* qs, int npad, int d,
                          int bpad, int n_valid, int tile_n, int seg,
                          int vcap, int ibase, void* segpack, void* tiletop,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e;
  switch (seg) {
#define CVT_CACHED(S)                                                      \
  case S:                                                                  \
    e = launch_segmin_cached<S>(dec8_t, norm_col, q2s, qs, npad, d, bpad,  \
                                n_valid, vcap, ibase, segpack, st);        \
    break;
    CVT_CACHED(128) CVT_CACHED(64) CVT_CACHED(32) CVT_CACHED(16) CVT_CACHED(8)
#undef CVT_CACHED
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  return launch_tiletop(static_cast<const int32_t*>(segpack), npad, bpad,
                        tile_n, seg, static_cast<int32_t*>(tiletop), st);
}

const char* cvt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
