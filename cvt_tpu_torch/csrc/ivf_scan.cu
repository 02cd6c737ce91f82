// IVF-ADC union-probe page scan kernel for Hopper (sm_90a), scored on the
// int8 tensor cores.
//
// Replaces the Pallas TPU kernel of cvt_tpu/ops/pallas/ivf_scan.py:
//   ivf_page_kernel <- _ivf_page_kernel (launched by _ivf_pages_segmin)
//
// What it computes. The database is a cell-sorted int8 residual cache
// dec8_t [D, N'] cut into pages of lp rows, each segment of SEG rows owned
// by one cell, seg_cell [N' / SEG] (-1: a dead segment); sel [S] lists the
// pages a query batch probes, the first n_live of them live (the rest fill
// slots). The coarse terms are one row per cell, cipc [Kc, Bpad]. For live
// slot i, page p = sel[i], segment s of p, a row r of s and query b:
//   c       = seg_cell[p*spt + s]
//   cip     = cipc[c, b] for 0 <= c < Kc, else BIG (3.4e38)
//   ip      = <dec8_t[:, r], q2s[b]>                 exact int32
//   norm_i  = clip(rint(nrm[r] / qs), 0, float(marker))
//   cip_i   = clip(rint(cip / qs), 0, float(marker))
//   key     = (ip + norm_i + cip_i) * SEG + r % SEG
// and segpack[i*spt + s, b] is the minimum key over the SEG rows of
// segment s of the page (spt = lp / SEG segments per page). A fill slot
// (i >= n_live) or a page id out of range reads nothing and writes
// INT32_MAX, which ranks after every key. The clips are taken in float32,
// as the TPU kernel takes them: float(marker) rounds the integer marker up
// when it exceeds 2^24 (32,522,143 -> 32,522,144 at SEG = 32, D = 128), and
// _ivf_pack_caps' bounds keep every key inside int32 for the rounded
// value, so the signed arithmetic never overflows. cip_i is constant over
// a segment, so it is added after the minimum.
//
// What bounds it on the H100: the bytes of the live pages. Per batch
// n_live * lp * D bytes of cache (134 MB at 2,050 live pages of 512 rows,
// D = 128), segpack written at n_live * spt * Bpad * 4 bytes (34 MB at
// Bpad = 256) and the rows of cipc that the live segments' cells name
// (at most Kc * Bpad * 4 bytes, 8 MB at Kc = 8,192): ~0.06 ms at
// 3.35 TB/s. The int8
// products, 2 * n_live * lp * D * Bpad = 6.9e10, take 0.035 ms at the
// 1,979 TOP/s tensor-core peak.
//
// What this design does about it: the cached ADC scan's machinery
// (hopper_int8.cuh). One block (one warpgroup) owns 128 rows of a page (a
// quarter at lp = 512), sel[slot] * lp + part * 128 onward, for the whole
// query batch: the page id, the live count and each of its segments'
// cells are one load each per block. It queues its first query tiles
// (cp.async) and the first tile's coarse terms, transposes its [D, 128] cache slice into swizzled K-major
// rows by word-wide 4 x 4 byte transposes (8 words in flight per thread),
// scores each 64-query tile on wgmma, and takes each segment's minimum in
// registers and over the quad by two shuffles. The epilogue adds the
// segment's clipped cip, read from its cell's row of cipc one query tile
// ahead so its latency hides behind a tile of products, and stores. The
// layout is cell-sorted, so neighbouring segments and pages mostly share
// a row, which L2 then serves. A block runs only Bpad / 64 query
// tiles, so latency, not throughput, sets its time: the key base column is
// read from shared memory rather than held in 32 registers, which leaves
// room for four blocks per SM. A whole page per block (four row tiles
// sharing one pass of the query ring) was slower on the H100 (PERF.md).
//
// Exactness rules: nrm / qs and cip / qs are IEEE divisions (__fdiv_rn),
// rintf rounds half to even like jnp.round, and the clip bound is
// __int2float_rn(marker), the float32 rounding of the marker.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_int8.cuh"

namespace {

using namespace hopper_int8;

// Dynamic shared memory of one block: 1,024 bytes of alignment slack, the
// row tile, nst query tiles and the key base column.
__host__ inline size_t page_smem_bytes(int d, int nst) {
  return 1024 + rows_bytes(d) + nst * qtile_bytes(d) + ROWS * sizeof(int);
}
// Query tiles in flight: STAGES where they fit, else 2 (the wrapper
// rejects shapes where 2 do not fit either).
__host__ inline int page_stages(int d) {
  return page_smem_bytes(d, STAGES) <= SMEM_OPTIN ? STAGES : 2;
}

__device__ __forceinline__ int clip_round(float x, float qs, float markf) {
  const float v = rintf(__fdiv_rn(x, qs));
  return (int)fminf(fmaxf(v, 0.0f), markf);
}

// The epilogue: the (segment, query) pair's clipped coarse term is added
// to its minimum key before the store. A lane's pairs are p = 4 i + tig
// (score_block's spread), pair p in segment p / 2 of the block; cell[i]
// is the cell of pair 4 i + tig's segment (-1: dead, or out of [0, Kc)).
// Tile holds the pairs' raw cip values for one query tile, clipped only
// at the store so the load is not waited on early.
template <int SEG>
struct PageStore {
  static constexpr int NS = ROWS / SEG;         // segments per block
  static constexpr int PAIRS = 2 * NS;          // per query row pair group
  static constexpr int NP = (PAIRS + 3) / 4;    // a lane's share
  struct Tile {
    float c[NP];
  };
  int32_t* segpack;
  const float* cipc;
  size_t seg0;  // the block's first segpack row
  int bpad;
  float qs, markf;
  int cell[NP];

  // the cells of the lane's segments: seg_cell holds the block's NS
  // segments from its first
  __device__ __forceinline__ void load_cells(const int32_t* seg_cell,
                                             int kc) {
    const int tig = threadIdx.x & 3;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int s = (4 * i + tig) >> 1;
      const int c = s < NS ? seg_cell[s] : -1;
      cell[i] = (unsigned)c < (unsigned)kc ? c : -1;
    }
  }
  __device__ __forceinline__ Tile load(int t) const {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int tig = lane & 3;
    const size_t q = (size_t)t * QT + 16 * warp + (lane >> 2);
    Tile r;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int p = 4 * i + tig;
      r.c[i] = p >= PAIRS    ? 0.0f
               : cell[i] < 0 ? 3.4e38f
                             : cipc[(size_t)cell[i] * bpad + q + 8 * (p & 1)];
    }
    return r;
  }
  __device__ __forceinline__ void store(const Tile& c, int i, int s,
                                        size_t q, int v) const {
    segpack[(seg0 + s) * bpad + q] = v + clip_round(c.c[i], qs, markf) * SEG;
  }
};

// grid.x = S * (lp / ROWS), THREADS threads, page_smem_bytes(d, NST) of
// dynamic shared memory. SEG in {16, 32, 64, 128}.
template <int SEG, int NST>
__global__ void __launch_bounds__(THREADS)
ivf_page_kernel(const int32_t* __restrict__ sel,
                const int32_t* __restrict__ n_live,
                const float* __restrict__ qs_p,
                const int8_t* __restrict__ dec8_t,
                const float* __restrict__ nrm,
                const float* __restrict__ cipc,
                const int32_t* __restrict__ seg_cell,
                const int8_t* __restrict__ q2s, int n_rows, int d, int bpad,
                int lp, int marker, int kc, bool vec16,
                int32_t* __restrict__ segpack) {
  constexpr int NS = ROWS / SEG;  // segments per block
  extern __shared__ unsigned char smem_raw[];
  int8_t* rows_s = reinterpret_cast<int8_t*>(align1024(smem_raw));
  int8_t* q_s = rows_s + rows_bytes(d);
  int* col_s = reinterpret_cast<int*>(q_s + NST * qtile_bytes(d));
  const int tid = threadIdx.x;

  const int bpp = lp / ROWS;  // blocks per page
  const int slot = blockIdx.x / bpp;
  const int part = blockIdx.x - slot * bpp;
  const size_t seg0 = (size_t)slot * (lp / SEG) + (size_t)part * NS;
  const int page = sel[slot];
  const int live = n_live == nullptr ? INT32_MAX : *n_live;
  if (slot >= live || page < 0 || (size_t)(page + 1) * lp > (size_t)n_rows) {
    // a fill slot or a page id out of range reads nothing: its segments
    // rank last
    for (int o = tid; o < NS * bpad; o += THREADS)
      segpack[seg0 * bpad + o] = INT32_MAX;
    return;
  }
  const float qs = *qs_p;
  const float markf = __int2float_rn(marker);
  const size_t row0 = (size_t)page * lp + (size_t)part * ROWS;

  PageStore<SEG> epi{segpack, cipc, seg0, bpad, qs, markf, {}};
  epi.load_cells(seg_cell + row0 / SEG, kc);
  q_ring_prologue<NST>(q_s, q2s, bpad / QT, d, vec16);
  zero_k_pad(rows_s, q_s, d, NST);
  const auto cip0 = epi.load(0);  // in flight through the transpose
  // row0 is a multiple of ROWS, so tid % SEG is the row's lane
  col_s[tid] =
      clip_round(nrm[row0 + tid], qs, markf) * SEG + (tid & (SEG - 1));
  transpose_rows(rows_s, dec8_t + row0, n_rows, d);
  fence_async_smem();
  __syncthreads();
  score_block<SEG, NST, false>(rows_s, q_s, col_s, q2s, bpad, d, vec16, epi,
                               cip0);
}

template <int SEG>
int launch_pages(const void* sel, const void* n_live, const void* qs,
                 const void* dec8_t, const void* nrm, const void* cipc,
                 const void* seg_cell, const void* q2s, int n_sel,
                 int n_rows, int d, int bpad, int lp, int marker, int kc,
                 void* segpack, cudaStream_t st) {
  const int nst = page_stages(d);
  return launch(nst == STAGES ? ivf_page_kernel<SEG, STAGES>
                              : ivf_page_kernel<SEG, 2>,
                page_smem_bytes(d, nst), n_sel * (lp / ROWS), st,
                static_cast<const int32_t*>(sel),
                static_cast<const int32_t*>(n_live),
                static_cast<const float*>(qs),
                static_cast<const int8_t*>(dec8_t),
                static_cast<const float*>(nrm),
                static_cast<const float*>(cipc),
                static_cast<const int32_t*>(seg_cell),
                static_cast<const int8_t*>(q2s), n_rows, d, bpad, lp, marker,
                kc, vec16_ok(q2s, d), static_cast<int32_t*>(segpack));
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (Bpad % 128 == 0, D % 4 == 0,
// lp % 128 == 0, N' % lp == 0, seg in {16, 32, 64, 128}, cipc [kc, Bpad]
// with kc >= 1, seg_cell [N' / seg] with every cell below kc, contiguous
// 4-byte-aligned tensors, the block's shared memory at two query stages
// within SMEM_OPTIN). n_live is a one-element int32 on the card, or null
// for every slot live. Returns 0 or the cudaError_t of the failed call.
int cvt_ivf_pages_segmin(const void* sel, const void* n_live, const void* qs,
                         const void* dec8_t, const void* nrm_col,
                         const void* cipc, const void* seg_cell,
                         const void* q2s, int n_sel, int n_rows, int d,
                         int bpad, int lp, int seg, int marker, int kc,
                         void* segpack, void* stream) {
  if (n_sel == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (seg) {
#define CVT_PAGES(S)                                                        \
  case S:                                                                   \
    return launch_pages<S>(sel, n_live, qs, dec8_t, nrm_col, cipc,          \
                           seg_cell, q2s, n_sel, n_rows, d, bpad, lp,       \
                           marker, kc, segpack, st);
    CVT_PAGES(16) CVT_PAGES(32) CVT_PAGES(64) CVT_PAGES(128)
#undef CVT_PAGES
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
