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
// transposed) once into a K-major, swizzled int8 tile in shared memory,
// and the queries stream past it through a cp.async ring onto the int8
// tensor cores (wgmma), with the segment minima taken in registers: the
// machinery of hopper_int8.cuh, which ivf_scan.cu shares. The ring holds
// three 64-query tiles, two where three do not fit in 227 KB: the cached
// kernel at 640 < D <= 896, which the int32 keys allow at SEG <= 64; the
// decode kernel's codebooks share the query region until the decode ends,
// which caps it at D <= 580 for k_sub = 256. Four blocks share an SM (128
// registers, 50 KB of shared memory each).
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

#include "hopper_int8.cuh"

namespace {

using namespace hopper_int8;

constexpr int IMAX = 2147000000;

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
  q_ring_prologue<NST>(q_s, q2s, bpad / QT, d, vec16);
  zero_k_pad(rows_s, q_s, d, NST);
  // row0 is a multiple of ROWS, so tid % SEG is the row's lane
  col_s[tid] = key_base<SEG>(row_norm(rows_s, tid, s2, d), *qs,
                             row0 + tid < (size_t)n_valid, vcap, ibase,
                             tid & (SEG - 1));
  fence_async_smem();
  __syncthreads();
  score_block<SEG, NST, true>(
      rows_s, q_s, col_s, q2s, bpad, d, vec16,
      SegStore{segpack, (size_t)blockIdx.x * (ROWS / SEG), bpad}, {});
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

  q_ring_prologue<NST>(q_s, q2s, bpad / QT, d, vec16);
  zero_k_pad(rows_s, q_s, d, NST);
  transpose_rows(rows_s, dec8_t + row0, npad, d);
  col_s[tid] = key_base<SEG>(norm_col[row0 + tid], *qs,
                             row0 + tid < (size_t)n_valid, vcap, ibase,
                             tid & (SEG - 1));
  fence_async_smem();
  __syncthreads();
  score_block<SEG, NST, true>(
      rows_s, q_s, col_s, q2s, bpad, d, vec16,
      SegStore{segpack, (size_t)blockIdx.x * (ROWS / SEG), bpad}, {});
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
                smem_bytes(d, cb, nst), npad / ROWS, st,
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
                smem_bytes(d, 0, nst), npad / ROWS, st,
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
