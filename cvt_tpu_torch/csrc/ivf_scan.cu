// IVF-ADC union-probe page scan kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of cvt_tpu/ops/pallas/ivf_scan.py:
//   ivf_page_kernel <- _ivf_page_kernel (launched by _ivf_pages_segmin)
//
// What it computes. The database is a cell-sorted int8 residual cache
// dec8_t [D, N'] cut into pages of lp rows; sel [S] lists the pages a query
// batch probes. For slot i, page p = sel[i], a row r of p and query b:
//   ip      = <dec8_t[:, r], q2s[b]>                 exact int32 (dp4a)
//   norm_i  = clip(rint(nrm[r] / qs), 0, float(marker))
//   cip_i   = clip(rint(cip[i*spt + s, b] / qs), 0, float(marker))
//   key     = (ip + norm_i + cip_i) * SEG + r % SEG
// and segpack[i*spt + s, b] is the minimum key over the SEG rows of
// segment s of the page (spt = lp / SEG segments per page). The clips are
// taken in float32, as the TPU kernel takes them: float(marker) rounds the
// integer marker up when it exceeds 2^24 (32,522,143 -> 32,522,144 at
// SEG = 32, D = 128), and _ivf_pack_caps' bounds keep every key inside
// int32 for the rounded value, so the signed arithmetic never overflows.
// cip_i is constant over a segment, so it is added after the minimum.
//
// What bounds it on the H100: int8 operations, 2 * S * lp * D * Bpad per
// batch (7.4e10 at S = 2,200 pages, lp = 512, D = 128, Bpad = 256); the
// bytes (S * lp * D of cache, 144 MB, plus cip and segpack at 36 MB each)
// take ~0.06 ms at 3.35 TB/s. dp4a runs on the CUDA cores, so the simple
// design is compute-bound far from the card's int8 tensor-core peak.
//
// What the simple design does about it: one block owns 128 rows (a
// quarter of a 512-row page, 128 / SEG whole segments) for the whole query
// batch; the page indirection is one load of sel[] per block. The block
// transposes its [D, 128] slice of the cache into rows in shared memory,
// then for each 128-query sub-tile each of 256 threads holds an 8 x 8
// register tile of int32 accumulators fed by dp4a from padded
// (bank-conflict-free) shared-memory rows. A thread's 8 rows (ty + 16 i)
// fall two to a segment at SEG = 32; the segment minima are reduced in
// registers, by one warp shuffle and through shared memory, and only
// segpack is written. Tensor-core scoring (mma / wgmma) and TMA are later
// work.
//
// Exactness rules: nrm / qs and cip / qs are IEEE divisions (__fdiv_rn),
// rintf rounds half to even like jnp.round, and the clip bound is
// __int2float_rn(marker), the float32 rounding of the marker.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;     // rows per block
constexpr int QT = 128;       // queries per sub-tile
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int WARPS = THREADS / 32;

// Shared-memory words: cache rows and query tile (both padded by one word
// per row), key base column, per-warp segment minima [WARPS][ROWS/seg][QT].
__host__ __device__ inline size_t page_smem_bytes(int d, int seg) {
  const int ldw = d / 4 + 1;
  return sizeof(int) *
         ((size_t)(ROWS + QT) * ldw + ROWS + (size_t)WARPS * (ROWS / seg) * QT);
}

__device__ __forceinline__ int clip_round(float x, float qs, float markf) {
  const float v = rintf(__fdiv_rn(x, qs));
  return (int)fminf(fmaxf(v, 0.0f), markf);
}

// grid.x = S * (lp / ROWS). SEG in {16, 32, 64, 128}: thread row ty + 16 i
// (ty < 16) lies in segment (16 i) / SEG of the block.
template <int SEG>
__global__ void __launch_bounds__(THREADS)
ivf_page_kernel(const int32_t* __restrict__ sel,
                const float* __restrict__ qs_p,
                const int8_t* __restrict__ dec8_t,
                const float* __restrict__ nrm,
                const float* __restrict__ cip,
                const int8_t* __restrict__ q2s, int n_rows, int d, int bpad,
                int lp, int marker, int32_t* __restrict__ segpack) {
  constexpr int SPB = ROWS / SEG;  // segments per block
  extern __shared__ int smem[];
  const int dw = d / 4, ldw = dw + 1;
  int* dec_w = smem;
  int* q_w = dec_w + ROWS * ldw;
  int* col_s = q_w + QT * ldw;
  int* red_s = col_s + ROWS;
  int8_t* dec_b = reinterpret_cast<int8_t*>(dec_w);
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;

  const int bpp = lp / ROWS;  // blocks per page
  const int slot = blockIdx.x / bpp;
  const int part = blockIdx.x - slot * bpp;
  const size_t out0 = (size_t)slot * (lp / SEG) + (size_t)part * SPB;
  const int page = sel[slot];
  const float qs = *qs_p;
  const float markf = __int2float_rn(marker);
  if (page < 0 || (size_t)(page + 1) * lp > (size_t)n_rows) {
    // a page id out of range reads nothing: its segments rank last
    for (int o = tid; o < SPB * bpad; o += THREADS)
      segpack[out0 * bpad + o] = INT32_MAX;
    return;
  }
  const size_t row0 = (size_t)page * lp + (size_t)part * ROWS;

  // transpose the [d, ROWS] cache slice into rows (coalesced along rows)
  for (int p = tid; p < d * ROWS; p += THREADS) {
    const int j = p / ROWS, r = p - j * ROWS;
    dec_b[r * ldw * 4 + j] = dec8_t[(size_t)j * n_rows + row0 + r];
  }
  // row0 is a multiple of ROWS, so tid % SEG is the row's lane
  if (tid < ROWS)
    col_s[tid] = clip_round(nrm[row0 + tid], qs, markf) * SEG + (tid & (SEG - 1));
  __syncthreads();
  int col[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) col[i] = col_s[ty + 16 * i];

  for (int q0 = 0; q0 < bpad; q0 += QT) {
    __syncthreads();  // the previous sub-tile is done with q_w and red_s
    const int* qg = reinterpret_cast<const int*>(q2s + (size_t)q0 * d);
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
      int mn[SPB];
#pragma unroll
      for (int s = 0; s < SPB; ++s) mn[s] = INT32_MAX;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int s = (16 * i) / SEG;
        mn[s] = min(mn[s], acc[i][j] * SEG + col[i]);
      }
#pragma unroll
      for (int s = 0; s < SPB; ++s) {
        // lanes l and l^16 hold rows ty and ty+1 of the same query
        const int v = min(mn[s], __shfl_xor_sync(0xffffffffu, mn[s], 16));
        if (lane < 16) red_s[(warp * SPB + s) * QT + tx + 16 * j] = v;
      }
    }
    __syncthreads();
    for (int o = tid; o < SPB * QT; o += THREADS) {
      const int s = o / QT, b = o - s * QT;
      int mn = red_s[s * QT + b];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) mn = min(mn, red_s[(w * SPB + s) * QT + b]);
      const size_t at = (out0 + s) * bpad + q0 + b;
      segpack[at] = mn + clip_round(cip[at], qs, markf) * SEG;
    }
  }
}

template <int SEG>
int launch(const int32_t* sel, const float* qs, const int8_t* dec8_t,
           const float* nrm, const float* cip, const int8_t* q2s, int n_sel,
           int n_rows, int d, int bpad, int lp, int marker, int32_t* segpack,
           cudaStream_t st) {
  const size_t smem = page_smem_bytes(d, SEG);
  cudaError_t e = cudaFuncSetAttribute(
      ivf_page_kernel<SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  ivf_page_kernel<SEG><<<n_sel * (lp / ROWS), THREADS, smem, st>>>(
      sel, qs, dec8_t, nrm, cip, q2s, n_rows, d, bpad, lp, marker, segpack);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (Bpad % 128 == 0, D % 4 == 0,
// lp % 128 == 0, N' % lp == 0, seg in {16, 32, 64, 128}, cip [S*lp/seg,
// Bpad], contiguous 4-byte-aligned tensors). Returns 0 or the cudaError_t of
// the failed call.
int cvt_ivf_pages_segmin(const void* sel, const void* qs, const void* dec8_t,
                         const void* nrm_col, const void* cip,
                         const void* q2s, int n_sel, int n_rows, int d,
                         int bpad, int lp, int seg, int marker,
                         void* segpack, void* stream) {
  if (n_sel == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const int32_t*>(sel);
  const auto* q = static_cast<const float*>(qs);
  const auto* dec = static_cast<const int8_t*>(dec8_t);
  const auto* nrm = static_cast<const float*>(nrm_col);
  const auto* c = static_cast<const float*>(cip);
  const auto* qq = static_cast<const int8_t*>(q2s);
  auto* out = static_cast<int32_t*>(segpack);
  switch (seg) {
    case 16:
      return launch<16>(s, q, dec, nrm, c, qq, n_sel, n_rows, d, bpad, lp,
                        marker, out, st);
    case 32:
      return launch<32>(s, q, dec, nrm, c, qq, n_sel, n_rows, d, bpad, lp,
                        marker, out, st);
    case 64:
      return launch<64>(s, q, dec, nrm, c, qq, n_sel, n_rows, d, bpad, lp,
                        marker, out, st);
    case 128:
      return launch<128>(s, q, dec, nrm, c, qq, n_sel, n_rows, d, bpad, lp,
                         marker, out, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
