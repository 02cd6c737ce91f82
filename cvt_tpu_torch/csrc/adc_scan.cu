// Packed segment-min ADC scan kernels for Hopper (sm_90a).
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
//   ip        = <dec_r, q2s_b>               exact int32 (dp4a)
//   norm_i    = clip(rint(norm_r / qs), 0, vcap), or ibase for r >= n_valid
//   key       = ip * SEG + norm_i * SEG + (r % SEG)
// and emit min(key) over each SEG-row segment (segpack [Npad/SEG, Bpad]),
// plus each tile's two best keys and their rows-in-tile (tiletop
// [n_tiles, 8, Bpad], rows 4-7 zero). The bounds of _pack_caps keep every
// key inside int32, so the signed arithmetic below never overflows.
//
// What bounds it on the H100: int8 operations, 2*Npad*D*B = 2.1e12 per
// batch at Npad = 1M, D = 128, B = 8192. Bytes are small beside that:
// codes 8 MB (or the decoded cache 128 MB) read once per block row, plus
// segpack ~260 MB written. dp4a runs on the CUDA cores (~1/16 of the int8
// tensor-core rate), so this simple design is compute-bound far from the
// card's peak.
//
// What the simple design does about it: one block owns 128 rows for the
// whole query batch, so each row is decoded once (the codebooks staged in
// shared memory, rows decoded by a shared-memory gather) and reused across
// all query sub-tiles; each thread holds an 8x8 register tile of int32
// accumulators fed by dp4a from padded (bank-conflict-free) shared-memory
// tiles; the segment minima are reduced in registers, by one warp shuffle,
// and through shared memory, so only segpack is written. Tensor-core
// (mma/wgmma) scoring, TMA and persistent blocks are later work.
//
// Segment sizes. SEG in {128, 64, 32, 16, 8} is a template parameter: a
// block holds 128 / SEG segments. A thread's rows ty + 16 i (ty < 16,
// i < 8) fall into segment (16 i) / SEG when SEG >= 16, the same for every
// thread, and into segment 2 i + ty / 8 at SEG = 8, where the two rows of
// a shuffle pair (ty = 2w, 2w + 1 in warp w) still share one. Each thread
// keeps one minimum per (query, slot), combines the pair by one shuffle,
// and the block combines the warps that cover a segment in shared memory.
// Integer minima are exact in any order, so SEG = 128 gives the bits of
// the one-segment-per-block design it replaces.
//
// Exactness rules: norm / qs is IEEE division (__fdiv_rn) and rintf rounds
// half to even like jnp.round; the float32 norm is summed in one fixed
// order (row_norm), the PyTorch twin's, so the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;     // rows per block
constexpr int QT = 128;       // queries per sub-tile
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int WARPS = THREADS / 32;
constexpr int IMAX = 2147000000;

// Minima a thread keeps per query: one per segment of the block at
// SEG >= 16, one per row (i) at SEG = 8.
template <int SEG>
__host__ __device__ constexpr int slots() { return SEG >= 16 ? ROWS / SEG : 8; }

// Shared-memory words for one block: decoded rows, query tile (both with
// a one-word pad per row), key base column, per-warp partial minima.
__host__ __device__ inline size_t score_smem_bytes(int d, int n_slots) {
  const int ldw = d / 4 + 1;
  return sizeof(int) *
         ((size_t)(ROWS + QT) * ldw + ROWS + (size_t)WARPS * n_slots * QT);
}

template <int SEG>
__device__ __forceinline__ int key_base(float norm, float qs, bool valid,
                                        int vcap, int ibase, int lane) {
  float x = rintf(__fdiv_rn(norm, qs));
  x = fminf(fmaxf(x, 0.0f), (float)vcap);
  return (valid ? (int)x : ibase) * SEG + lane;
}

// sum_d row[d]^2 * s2[d] in the twin's order (_row_norms): 32 interleaved
// FMA accumulators, lanes combined ((0-7 + 8-15) + 16-23) + 24-31, then
// halved 8 -> 4 -> 2 -> 1.
__device__ __forceinline__ float row_norm(const int8_t* row,
                                          const float* __restrict__ s2,
                                          int d) {
  float a[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) a[j] = 0.0f;
  for (int d0 = 0; d0 < d; d0 += 32) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (d0 + j < d) {
        const float v = (float)row[d0 + j];
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

// Scores the block's ROWS decoded rows (dec_w, word rows of stride ldw)
// against every query, writing the block's ROWS / SEG segment minima per
// query into segpack rows seg0 .. seg0 + ROWS / SEG.
template <int SEG>
__device__ void score_segment(const int* __restrict__ dec_w,
                              const int* __restrict__ col_s,
                              int* __restrict__ q_w, int* __restrict__ red_s,
                              const int8_t* __restrict__ q2s, int bpad,
                              int dw, int32_t* __restrict__ segpack,
                              size_t seg0) {
  constexpr int SPB = ROWS / SEG;    // segments per block
  constexpr int NS = slots<SEG>();
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int ldw = dw + 1;
  int col[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) col[i] = col_s[ty + 16 * i];

  for (int q0 = 0; q0 < bpad; q0 += QT) {
    __syncthreads();  // the previous sub-tile is done with q_w and red_s
    const int* qg = reinterpret_cast<const int*>(q2s + (size_t)q0 * dw * 4);
    for (int i = tid; i < QT * dw; i += THREADS) {
      const int r = i / dw;
      q_w[r * ldw + (i - r * dw)] = qg[i];
    }
    __syncthreads();

    int acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0;
    for (int w = 0; w < dw; ++w) {
      int a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = dec_w[(ty + 16 * i) * ldw + w];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = q_w[(tx + 16 * j) * ldw + w];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int mn[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) mn[s] = INT32_MAX;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = SEG >= 16 ? (16 * i) / SEG : i;
        mn[s] = min(mn[s], acc[i][j] * SEG + col[i]);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        // lanes l and l^16 hold rows ty and ty+1 of the same query
        const int v = min(mn[s], __shfl_xor_sync(0xffffffffu, mn[s], 16));
        if (lane < 16) red_s[(warp * NS + s) * QT + tx + 16 * j] = v;
      }
    }
    __syncthreads();
    for (int o = tid; o < SPB * QT; o += THREADS) {
      const int s = o / QT, b = o - s * QT;
      int mn = INT32_MAX;
      if (SEG >= 16) {
#pragma unroll
        for (int w = 0; w < WARPS; ++w) mn = min(mn, red_s[(w * NS + s) * QT + b]);
      } else {
        // segment 2 i + h: slot i of the warps whose rows have ty / 8 == h
        const int h = s & 1, slot = s >> 1;
#pragma unroll
        for (int w = 4 * h; w < 4 * h + 4; ++w)
          mn = min(mn, red_s[(w * NS + slot) * QT + b]);
      }
      segpack[(seg0 + s) * bpad + q0 + b] = mn;
    }
  }
}

// grid.x = Npad / ROWS. Dynamic shared memory: score_smem_bytes(d, NS)
// plus the int8 codebooks [m, k_sub, ds].
template <int SEG>
__global__ void __launch_bounds__(THREADS)
adc_segmin_kernel(const uint8_t* __restrict__ codes,
                  const int8_t* __restrict__ cb_q,
                  const int8_t* __restrict__ q2s,
                  const float* __restrict__ s2, const float* __restrict__ qs,
                  int m, int k_sub, int ds, int bpad, int n_valid, int vcap,
                  int ibase, int32_t* __restrict__ segpack) {
  extern __shared__ int smem[];
  const int d = m * ds, dw = d / 4, ldw = dw + 1;
  int* dec_w = smem;
  int* q_w = dec_w + ROWS * ldw;
  int* col_s = q_w + QT * ldw;
  int* red_s = col_s + ROWS;
  int8_t* cb_s = reinterpret_cast<int8_t*>(red_s + WARPS * slots<SEG>() * QT);
  int8_t* dec_b = reinterpret_cast<int8_t*>(dec_w);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * ROWS;

  // stage the codebooks (k_sub * d bytes, d % 4 == 0)
  const int cb_words = k_sub * d / 4;
  for (int i = tid; i < cb_words; i += THREADS)
    reinterpret_cast<int*>(cb_s)[i] = reinterpret_cast<const int*>(cb_q)[i];
  __syncthreads();

  // decode by shared-memory gather: one (row, subspace) pair per step;
  // a code past k_sub decodes to zeros, as a one-hot product would
  for (int p = tid; p < ROWS * m; p += THREADS) {
    const int r = p / m, mm = p - r * m;
    const int code = codes[(row0 + r) * m + mm];
    int8_t* dst = dec_b + r * ldw * 4 + mm * ds;
    const int8_t* src = cb_s + ((size_t)mm * k_sub + code) * ds;
    for (int t = 0; t < ds; ++t) dst[t] = code < k_sub ? src[t] : 0;
  }
  __syncthreads();

  // row0 is a multiple of ROWS, so tid % SEG is the row's lane
  if (tid < ROWS) {
    col_s[tid] = key_base<SEG>(row_norm(dec_b + tid * ldw * 4, s2, d), *qs,
                               row0 + tid < (size_t)n_valid, vcap, ibase,
                               tid & (SEG - 1));
  }
  __syncthreads();
  score_segment<SEG>(dec_w, col_s, q_w, red_s, q2s, bpad, dw, segpack,
                     (size_t)blockIdx.x * (ROWS / SEG));
}

// grid.x = Npad / ROWS; dec8_t [d, npad] int8, norm_col [npad] f32.
template <int SEG>
__global__ void __launch_bounds__(THREADS)
adc_segmin_cached_kernel(const int8_t* __restrict__ dec8_t,
                         const float* __restrict__ norm_col,
                         const int8_t* __restrict__ q2s,
                         const float* __restrict__ qs, int npad, int d,
                         int bpad, int n_valid, int vcap, int ibase,
                         int32_t* __restrict__ segpack) {
  extern __shared__ int smem[];
  const int dw = d / 4, ldw = dw + 1;
  int* dec_w = smem;
  int* q_w = dec_w + ROWS * ldw;
  int* col_s = q_w + QT * ldw;
  int* red_s = col_s + ROWS;
  int8_t* dec_b = reinterpret_cast<int8_t*>(dec_w);
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)blockIdx.x * ROWS;

  // transpose the [d, ROWS] cache block into rows (coalesced along rows)
  for (int p = tid; p < d * ROWS; p += THREADS) {
    const int j = p / ROWS, r = p - j * ROWS;
    dec_b[r * ldw * 4 + j] = dec8_t[(size_t)j * npad + row0 + r];
  }
  if (tid < ROWS)
    col_s[tid] = key_base<SEG>(norm_col[row0 + tid], *qs,
                               row0 + tid < (size_t)n_valid, vcap, ibase,
                               tid & (SEG - 1));
  __syncthreads();
  score_segment<SEG>(dec_w, col_s, q_w, red_s, q2s, bpad, dw, segpack,
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

template <int SEG>
int launch_segmin(const void* codes, const void* cb_q, const void* q2s,
                  const void* s2, const void* qs, int npad, int m, int k_sub,
                  int ds, int bpad, int n_valid, int vcap, int ibase,
                  void* segpack, cudaStream_t st) {
  const int d = m * ds;
  const size_t smem = score_smem_bytes(d, slots<SEG>()) + (size_t)k_sub * d;
  cudaError_t e = cudaFuncSetAttribute(
      adc_segmin_kernel<SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  adc_segmin_kernel<SEG><<<npad / ROWS, THREADS, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(cb_q),
      static_cast<const int8_t*>(q2s), static_cast<const float*>(s2),
      static_cast<const float*>(qs), m, k_sub, ds, bpad, n_valid, vcap,
      ibase, static_cast<int32_t*>(segpack));
  return (int)cudaGetLastError();
}

template <int SEG>
int launch_segmin_cached(const void* dec8_t, const void* norm_col,
                         const void* q2s, const void* qs, int npad, int d,
                         int bpad, int n_valid, int vcap, int ibase,
                         void* segpack, cudaStream_t st) {
  const size_t smem = score_smem_bytes(d, slots<SEG>());
  cudaError_t e = cudaFuncSetAttribute(
      adc_segmin_cached_kernel<SEG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  adc_segmin_cached_kernel<SEG><<<npad / ROWS, THREADS, smem, st>>>(
      static_cast<const int8_t*>(dec8_t), static_cast<const float*>(norm_col),
      static_cast<const int8_t*>(q2s), static_cast<const float*>(qs), npad, d,
      bpad, n_valid, vcap, ibase, static_cast<int32_t*>(segpack));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (Bpad % 128 == 0, D % 4 == 0,
// seg in {128, 64, 32, 16, 8}, tile_n % seg == 0, Npad % tile_n == 0,
// Npad % 128 == 0, contiguous 4-byte-aligned tensors). Returns 0 or the
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
