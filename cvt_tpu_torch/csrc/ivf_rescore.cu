// IVF-ADC phase 2 for Hopper (sm_90a): each query's k + slack best
// segments of the page scan, their rows rescored in float32 from the int16
// decode, and the k best rows.
//
// Replaces no TPU kernel: cvt_tpu computes phase 2 of ivf_union_search
// (cvt_tpu/ops/pallas/ivf_scan.py) in jnp, and the port computed it in
// plain PyTorch (ivf_rescore_plain in ops/kernels/ivf_scan.py, now this
// kernel's twin). That code wrote every intermediate to device memory at
// full size: a transposed float32 copy of segpack, the radix passes and tie
// counts of the top-k over it, the gathered [B, C, D] int16 rows, their
// float32 copy and the products.
//
// What it computes (the twin's contract). segpack [S*spt, Bpad] holds, for
// segment row r and query b, the int32 key of phase 1; rows of slots past
// n_live hold INT32_MAX. For each query b < B:
//   1. the n_take = min(k + slack, S*spt) segment rows of least
//      (float32(key), r): float32, as cvt_tpu ranks them, so nearby large
//      keys tie and the lower r wins;
//   2. for the winner of rank j (slot = r / spt, global segment g =
//      sel[slot] * spt + r % spt) and lane l, the row
//      clamp(g * seg + l, 0, N' - 1) of cell c = seg_cell[clamp(g)] and
//        dist = ((q_sq + (nrm + dsq_min)) + -2 coarse_ip[b, c])
//               - 2 <q * srow16, dec16[row]>
//      at candidate position j * seg + l; +inf where rowids[row] < 0, c < 0,
//      nrm + dsq_min >= BIG / 2, slot >= n_live, or (exact_probe) b did not
//      probe c;
//   3. the k_eff = min(k, n_take * seg) least (dist, position): dists and
//      rowids, +inf / -1 where dist is not finite and past k_eff.
// Rows of slots past n_live are not read: INT32_MAX ranks after every live
// key (ties go to the lower r, and live slots come first), so such a slot
// wins only a rank the live segments leave empty, and every row of it is
// masked. Such a rank is left empty here: its rows are +inf all the same.
//
// What bounds it on the H100: bytes. segpack read once, S*spt * B * 4
// bytes (577 MB at the IVF cell: 35,200 segment rows, B 4,096), and each
// query's n_take * seg winning rows of D int16 read once (4,096 * 16 * 32
// * 256 bytes = 537 MB): ~1.1 GB a batch, 0.33 ms at 3.35 TB/s. Rows that
// several queries win are distinct bytes only once, and there are no more
// of them than the index's rows, so the least the work needs is lower
// (876 MB, 0.26 ms on a 1M-row index at that shape). The chunk lists
// (B * n_chunks * NT * 8 bytes, 2 MB there) are written and read once;
// nothing else scales with B * S*spt or with B * C * D.
//
// What this design does about it. Two launches, because one cannot fill
// 132 SMs at both B 4,096 and B 256: the selection needs the segment rows
// split across blocks, and the rescore needs the whole selection.
//   ivf_segsel_kernel<NT>: grid (ceil(B / 32), n_chunks), 256 threads. A
//   lane is a query, so a warp reads 32 neighbouring columns of a segpack
//   row (128 bytes, coalesced) and the 8 warps take every 8th row of the
//   block's chunk, 8 rows in flight. Each thread keeps its NT best (float
//   key, row) sorted in registers; a key enters only when strictly below
//   the NT-th, since a thread's rows arrive in increasing order (an equal
//   key loses its tie). The warps' lists are merged per query through
//   shared memory and the chunk's NT best written to cand[chunk][i][b].
//   The chunk count comes from the shapes: as many as fill the card's
//   resident blocks once (ops/kernels/ivf_scan.py, _rescore_geometry).
//   ivf_rescore_kernel: one block per query. Warp 0 merges the sorted
//   chunk lists by repeated warp minimum on (float key, row): the n_take
//   winners in rank order. One thread per winner resolves its page, cell,
//   coarse term and mask. A warp then scores 4 rows at a time, a lane 4
//   int16 of each per step (one 256-byte row of D = 128 in one warp load,
//   4 rows in flight), reduced over the warp by a butterfly (every lane
//   ends with the same sum). Distances and ids stay in shared memory;
//   warp 0 takes the k best by (distance, position).
// A thread keeps at most 64 keys in registers. Above that (k + slack >
// 64) the selection runs in rounds of 64: each round's selection pass
// ranks only the rows past the last round's winner (lo), and
// ivf_segmerge_kernel merges its chunk lists into the winners (win), so
// segpack is read once a round. Where the n_take * seg candidates'
// distances and ids do not fit a block's shared memory, they live in
// device memory (key_g, id_g) instead. Neither happens at k 10.
//
// Float rules: the same IEEE operations as the twin in the same order
// (__fmul_rn / __fadd_rn / __fsub_rn, no contraction), except the inner
// product, which sums its D products in another order: the kernel's and
// the twin's distances differ by at most ~4 D 2^-24 sum_i |q_i srow16_i
// dec_i|. The keys are ranked as the twin ranks them, exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QG = 32;        // queries of a selection block: one a lane
constexpr int UNROLL = 8;     // segpack rows in flight per thread
constexpr int SCORE_ROWS = 4; // rows a warp scores at once
constexpr int LONGEST = 64;   // the longest list a selection thread keeps
constexpr unsigned FULL = 0xffffffffu;
using u64 = unsigned long long;
constexpr u64 NONE = ~0ull;
constexpr float HALF_BIG = 1.7e38f;  // BIG / 2 in float32

// A float as an unsigned key of the same order, and (key, index) as one
// 64-bit key: smaller is better, ties to the lower index.
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unordered(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}
__device__ __forceinline__ u64 rank_key(float f, uint32_t i) {
  return ((u64)ordered(f) << 32) | i;
}

// Insert (v, r) into a thread's sorted list if v is strictly below its
// last entry.
template <int NT>
__device__ __forceinline__ void push(float (&kf)[NT], int (&ki)[NT], float v,
                                     int r) {
  if (v < kf[NT - 1]) {
    kf[NT - 1] = v;
    ki[NT - 1] = r;
#pragma unroll
    for (int i = NT - 1; i > 0; --i) {
      const bool s = kf[i] < kf[i - 1];
      const float a = kf[i], c = kf[i - 1];
      const int ia = ki[i], ic = ki[i - 1];
      kf[i - 1] = s ? a : c;
      kf[i] = s ? c : a;
      ki[i - 1] = s ? ia : ic;
      ki[i] = s ? ic : ia;
    }
  }
}

// Rank segpack row r's key v: into the list unless FLOOR and its
// (float key, row) lies below floor_q.
template <int NT, bool FLOOR>
__device__ __forceinline__ void take(float (&kf)[NT], int (&ki)[NT],
                                     int32_t v, int r, u64 floor_q) {
  const float f = __int2float_rn(v);
  if (!FLOOR || rank_key(f, (uint32_t)r) >= floor_q) push<NT>(kf, ki, f, r);
}

// Dynamic shared memory of one ivf_segsel_kernel block: the warps' lists
// [WARPS][NT][QG] u64 and their heads [WARPS][QG] i32.
__host__ inline size_t segsel_smem_bytes(int nt) {
  return (size_t)WARPS * QG * (nt * sizeof(u64) + sizeof(int));
}

// grid (ceil(B / QG), n_chunks), THREADS threads, segsel_smem_bytes(NT)
// of dynamic shared memory. cand [n_chunks][NT][B]: each chunk's NT best
// (float key, row) keys for each query, sorted, NONE past its rows. With
// FLOOR, query b ranks only the rows whose key is at least lo[b] (the
// rounds of a selection longer than NT).
template <int NT, int MIN_BLOCKS, bool FLOOR>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
ivf_segsel_kernel(const int32_t* __restrict__ segpack,
                  const int32_t* __restrict__ n_live, int n_slots, int spt,
                  int bpad, int b, int chunk_rows,
                  const u64* __restrict__ lo, u64* __restrict__ cand) {
  extern __shared__ u64 lists[];  // [WARPS][NT][QG], then the heads
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = blockIdx.x * QG + lane;
  const int chunk = blockIdx.y;
  const int live = min(max(*n_live, 0), n_slots);
  const int r0 = chunk * chunk_rows;
  const int r1 = min(r0 + chunk_rows, live * spt);

  float kf[NT];
  int ki[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    kf[i] = INFINITY;
    ki[i] = -1;
  }
  if (q < b) {
    const int32_t* col = segpack + q;
    const u64 floor_q = FLOOR ? lo[q] : 0;
    int r = r0 + warp;
    for (; r + (UNROLL - 1) * WARPS < r1; r += UNROLL * WARPS) {
      int32_t v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = __ldcs(col + (size_t)(r + u * WARPS) * bpad);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        take<NT, FLOOR>(kf, ki, v[u], r + u * WARPS, floor_q);
    }
    for (; r < r1; r += WARPS)
      take<NT, FLOOR>(kf, ki, __ldcs(col + (size_t)r * bpad), r, floor_q);
  }
#pragma unroll
  for (int i = 0; i < NT; ++i)
    lists[(warp * NT + i) * QG + lane] =
        ki[i] < 0 ? NONE : rank_key(kf[i], (uint32_t)ki[i]);
  __syncthreads();
  if (warp != 0 || q >= b) return;
  // merge the 8 warps' sorted lists of this lane's query, each list's head
  // kept in shared memory after the lists (a lane touches its own column)
  int* head = reinterpret_cast<int*>(lists + WARPS * NT * QG);
  for (int w = 0; w < WARPS; ++w) head[w * QG + lane] = 0;
  for (int i = 0; i < NT; ++i) {
    u64 best = NONE;
    int bw = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int hd = head[w * QG + lane];
      const u64 v = hd < NT ? lists[(w * NT + hd) * QG + lane] : NONE;
      if (v < best) {
        best = v;
        bw = w;
      }
    }
    cand[((size_t)chunk * NT + i) * b + q] = best;
    head[bw * QG + lane] += 1;
  }
}

// Dynamic shared memory of one ivf_rescore_kernel block, in this order:
// the folded query [d] f32, winners' global segments [n_take] i64, the
// candidates' keys [c] u64 and ids [c] i32 (unless they spill to device
// memory), chunk heads [n_chunks], winners' segpack rows and masks
// [n_take] i32 and coarse terms [n_take] f32 (c = n_take * seg).
__host__ inline size_t rescore_smem_bytes(int d, int n_take, int seg,
                                          int n_chunks, bool spill) {
  const size_t c = spill ? 0 : (size_t)n_take * seg;
  return 4 * (size_t)d + 12 * c + 20 * (size_t)n_take + 4 * (size_t)n_chunks;
}

__device__ __forceinline__ void warp_min(u64& v, int& c) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const u64 ov = __shfl_xor_sync(FULL, v, o);
    const int oc = __shfl_xor_sync(FULL, c, o);
    if (ov < v || (ov == v && oc < c)) {
      v = ov;
      c = oc;
    }
  }
}

// One warp merges query qi's sorted chunk lists (cand [n_chunks][nt][b])
// by repeated warp minimum on (float key, row): rows[0, n) get the n
// winners' segpack rows in rank order, -1 past the last. head [n_chunks]
// is the warp's own. Returns how many it found and sets last to the last
// one's key (NONE if none), the same on every lane.
__device__ int merge_lists(const u64* __restrict__ cand, int nt,
                           int n_chunks, int b, int qi, int* head, int* rows,
                           int n, u64& last) {
  const int lane = threadIdx.x & 31;
  for (int c = lane; c < n_chunks; c += 32) head[c] = 0;
  __syncwarp();
  last = NONE;
  int j = 0;
  for (; j < n; ++j) {
    u64 best = NONE;
    int bc = INT32_MAX;
    for (int c = lane; c < n_chunks; c += 32) {  // lane c % 32 owns list c
      const int hd = head[c];
      const u64 v = hd < nt ? cand[((size_t)c * nt + hd) * b + qi] : NONE;
      if (v < best) {
        best = v;
        bc = c;
      }
    }
    warp_min(best, bc);
    if (best == NONE) break;  // the same on every lane
    last = best;
    if (lane == 0) rows[j] = (int)(uint32_t)best;
    if (lane == (bc & 31)) head[bc] += 1;
    __syncwarp();
  }
  for (int jj = j + lane; jj < n; jj += 32) rows[jj] = -1;
  __syncwarp();
  return j;
}

// A round of a selection longer than the lists: grid ceil(B / WARPS),
// THREADS threads, WARPS * n_chunks ints of dynamic shared memory; a warp
// a query. Writes the round's n winners to win[b][off, off + n) and moves
// lo[b] past the last of them (to NONE once the rows run out, so that no
// later round takes one).
__global__ void __launch_bounds__(THREADS)
ivf_segmerge_kernel(const u64* __restrict__ cand, int nt, int n_chunks,
                    int b, int n_take, int off, int n,
                    int32_t* __restrict__ win, u64* __restrict__ lo) {
  extern __shared__ int heads[];  // [WARPS][n_chunks]
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * WARPS + warp;
  if (qi >= b) return;
  u64 last;
  const int found = merge_lists(cand, nt, n_chunks, b, qi,
                                heads + warp * n_chunks,
                                win + (size_t)qi * n_take + off, n, last);
  if ((threadIdx.x & 31) == 0) lo[qi] = found == n ? last + 1 : NONE;
}

// grid B, THREADS threads, rescore_smem_bytes(...) of dynamic shared memory.
// win (or null): the n_take winners of each query already merged, [B,
// n_take] segpack rows; else the block merges cand. key_g / id_g (or
// null): [B, n_take * seg] in device memory for the candidates, where
// they do not fit in shared memory.
__global__ void __launch_bounds__(THREADS)
ivf_rescore_kernel(const u64* __restrict__ cand, int nt, int n_chunks,
                   const int32_t* __restrict__ win, u64* __restrict__ key_g,
                   int32_t* __restrict__ id_g,
                   const int32_t* __restrict__ n_live,
                   const int32_t* __restrict__ sel,
                   const int32_t* __restrict__ rowids,
                   const int32_t* __restrict__ seg_cell,
                   const int16_t* __restrict__ dec16,
                   const float* __restrict__ srow16,
                   const float* __restrict__ nrm_col, float dsq_min,
                   const float* __restrict__ q, const float* __restrict__ q_sq,
                   const float* __restrict__ coarse_ip,
                   const bool* __restrict__ probed, int b, int n_slots,
                   int spt, int seg, int n_rows, int d, int kc, int n_take,
                   int k, int k_eff, bool exact_probe,
                   float* __restrict__ out_d, int32_t* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c_rows = n_take * seg;
  const int qi = blockIdx.x;
  const bool spill = key_g != nullptr;
  float* qf_s = reinterpret_cast<float*>(smem);
  long long* gseg_s = reinterpret_cast<long long*>(qf_s + d);
  u64* key_s = spill ? key_g + (size_t)qi * c_rows
                     : reinterpret_cast<u64*>(gseg_s + n_take);
  int* id_s = spill ? id_g + (size_t)qi * c_rows
                    : reinterpret_cast<int*>(key_s + c_rows);
  int* head_s = spill ? reinterpret_cast<int*>(gseg_s + n_take)
                      : id_s + c_rows;
  int* win_s = head_s + n_chunks;
  int* ok_s = win_s + n_take;
  float* cip_s = reinterpret_cast<float*>(ok_s + n_take);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qrow = (size_t)qi * kc;

  for (int j = tid; j < d; j += THREADS)
    qf_s[j] = __fmul_rn(q[(size_t)qi * d + j], srow16[j]);

  // 1. the n_take winning segment rows, in rank order (-1: none left)
  if (win != nullptr) {
    for (int j = tid; j < n_take; j += THREADS)
      win_s[j] = win[(size_t)qi * n_take + j];
  } else if (warp == 0) {
    u64 last;
    merge_lists(cand, nt, n_chunks, b, qi, head_s, win_s, n_take, last);
  }
  __syncthreads();

  // 2. each winner's global segment, cell term and mask
  const int live = *n_live;
  const long long n_segs = n_rows / seg;
  for (int j = tid; j < n_take; j += THREADS) {
    const int r = win_s[j];
    long long g = 0;
    int ok = 0;
    float cip = 0.0f;
    if (r >= 0) {
      const int slot = r / spt;
      g = (long long)sel[min(slot, n_slots - 1)] * spt + r % spt;
      const int cell = seg_cell[min(max(g, 0LL), n_segs - 1)];
      const int cc = min(max(cell, 0), kc - 1);
      cip = -2.0f * coarse_ip[qrow + cc];
      ok = slot < live && cell >= 0 && (!exact_probe || probed[qrow + cc]);
    }
    gseg_s[j] = g;
    ok_s[j] = ok;
    cip_s[j] = cip;
  }
  __syncthreads();

  // 3. every candidate row's distance, SCORE_ROWS rows a warp at a time
  const float qsq = q_sq[qi];
  const int d4 = d >> 2;
  const float4* qf4 = reinterpret_cast<const float4*>(qf_s);
  for (int p0 = warp * SCORE_ROWS; p0 < c_rows; p0 += WARPS * SCORE_ROWS) {
    long long row[SCORE_ROWS];
#pragma unroll
    for (int u = 0; u < SCORE_ROWS; ++u) {
      const int pos = p0 + u, j = pos / seg;
      row[u] = win_s[j] < 0
                   ? -1
                   : min(max(gseg_s[j] * seg + (pos - j * seg), 0LL),
                         (long long)n_rows - 1);
    }
    // the row's id and norm, loaded by lane u for row u beside the products
    int my_id = -1;
    float my_nrm = 0.0f;
    long long my_row = -1;
#pragma unroll
    for (int u = 0; u < SCORE_ROWS; ++u)
      if (lane == u) my_row = row[u];
    if (my_row >= 0) {
      my_id = rowids[my_row];
      my_nrm = nrm_col[my_row];
    }
    float acc[SCORE_ROWS];
#pragma unroll
    for (int u = 0; u < SCORE_ROWS; ++u) acc[u] = 0.0f;
    for (int c = lane; c < d4; c += 32) {
      int2 w[SCORE_ROWS];
#pragma unroll
      for (int u = 0; u < SCORE_ROWS; ++u)
        w[u] = row[u] >= 0 ? __ldg(reinterpret_cast<const int2*>(
                                 dec16 + row[u] * d) + c)
                           : make_int2(0, 0);
      const float4 f = qf4[c];
#pragma unroll
      for (int u = 0; u < SCORE_ROWS; ++u) {
        acc[u] = fmaf((float)(short)(w[u].x & 0xffff), f.x, acc[u]);
        acc[u] = fmaf((float)(w[u].x >> 16), f.y, acc[u]);
        acc[u] = fmaf((float)(short)(w[u].y & 0xffff), f.z, acc[u]);
        acc[u] = fmaf((float)(w[u].y >> 16), f.w, acc[u]);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < SCORE_ROWS; ++u)
        acc[u] = __fadd_rn(acc[u], __shfl_xor_sync(FULL, acc[u], o));
    if (lane < SCORE_ROWS) {
      float ip = acc[0];
#pragma unroll
      for (int u = 1; u < SCORE_ROWS; ++u)
        if (lane == u) ip = acc[u];
      const int pos = p0 + lane, j = pos / seg;
      float dist = INFINITY;
      if (my_row >= 0) {
        const float nrm = __fadd_rn(my_nrm, dsq_min);
        if (ok_s[j] && my_id >= 0 && nrm < HALF_BIG)
          dist = __fsub_rn(__fadd_rn(__fadd_rn(qsq, nrm), cip_s[j]),
                           __fmul_rn(2.0f, ip));
      }
      key_s[pos] = rank_key(dist, (uint32_t)pos);
      id_s[pos] = my_id;
    }
  }
  __syncthreads();

  // 4. the k_eff best (distance, position); lane p % 32 owns position p
  if (warp != 0) return;
  u64 mine = NONE;
  for (int p = lane; p < c_rows; p += 32) mine = min(mine, key_s[p]);
  float* od = out_d + (size_t)qi * k;
  int32_t* oi = out_i + (size_t)qi * k;
  for (int i = 0; i < k_eff; ++i) {
    u64 best = mine;
    int unused = 0;
    warp_min(best, unused);
    const int pos = (int)(uint32_t)best;
    if (lane == (pos & 31)) {
      key_s[pos] = NONE;
      mine = NONE;
      for (int p = lane; p < c_rows; p += 32) mine = min(mine, key_s[p]);
    }
    if (lane == 0) {
      const float dist = unordered((uint32_t)(best >> 32));
      const bool fin = isfinite(dist);
      od[i] = fin ? dist : INFINITY;
      oi[i] = fin ? id_s[pos] : -1;
    }
  }
  for (int i = k_eff + lane; i < k; i += 32) {
    od[i] = INFINITY;
    oi[i] = -1;
  }
}

template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, size_t smem, cudaStream_t st,
           A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

template <int NT, int MIN_BLOCKS, bool FLOOR = false>
int launch_segsel(const void* segpack, const void* n_live, int n_slots,
                  int spt, int bpad, int b, int n_chunks, int chunk_rows,
                  const u64* lo, void* cand, cudaStream_t st) {
  return launch(ivf_segsel_kernel<NT, MIN_BLOCKS, FLOOR>,
                dim3((b + QG - 1) / QG, n_chunks),
                segsel_smem_bytes(NT), st,
                static_cast<const int32_t*>(segpack),
                static_cast<const int32_t*>(n_live), n_slots, spt, bpad, b,
                chunk_rows, lo, static_cast<u64*>(cand));
}

// A selection of n_take > LONGEST: rounds of LONGEST winners, each
// ranking only the rows past the last round's (lo), merged into win.
int select_rounds(const void* segpack, const void* n_live, int n_slots,
                  int spt, int bpad, int b, int n_chunks, int chunk_rows,
                  int n_take, void* cand, int32_t* win, u64* lo,
                  cudaStream_t st) {
  cudaError_t ce = cudaMemsetAsync(lo, 0, (size_t)b * sizeof(u64), st);
  if (ce != cudaSuccess) return (int)ce;
  for (int off = 0; off < n_take; off += LONGEST) {
    int e = launch_segsel<LONGEST, 1, true>(segpack, n_live, n_slots, spt,
                                            bpad, b, n_chunks, chunk_rows,
                                            lo, cand, st);
    if (e != 0) return e;
    e = launch(ivf_segmerge_kernel, dim3((b + WARPS - 1) / WARPS),
               (size_t)WARPS * n_chunks * sizeof(int), st,
               static_cast<const u64*>(cand), LONGEST, n_chunks, b, n_take,
               off, min(LONGEST, n_take - off), win, lo);
    if (e != 0) return e;
  }
  return 0;
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (ivf_rescore): contiguous
// tensors, segpack [n_slots * spt, bpad >= b], dec16 [n_rows, d] 8-byte
// aligned with d % 4 == 0, seg in {16, 32, 64, 128}, nt in {16, 32, 64}
// and n_take <= nt unless n_take > 64 (then nt 64), n_chunks * chunk_rows
// >= n_slots * spt, cand [n_chunks, nt, b] int64, the rescore block's
// shared memory within the opt-in. win [b, n_take] int32 and lo [b] int64
// when n_take > 64, else null; key_g [b, n_take * seg] int64 and id_g
// [b, n_take * seg] int32 when the candidates spill, else null. n_live is
// a one-element int32 on the card. Returns 0 or the cudaError_t of the
// failed call.
int cvt_ivf_rescore(const void* segpack, const void* n_live, const void* sel,
                    const void* rowids, const void* seg_cell,
                    const void* dec16, const void* srow16,
                    const void* nrm_col, float dsq_min, const void* q,
                    const void* q_sq, const void* coarse_ip,
                    const void* probed, int b, int bpad, int n_slots, int spt,
                    int seg, int n_rows, int d, int kc, int n_take, int k,
                    int exact_probe, int nt, int n_chunks, int chunk_rows,
                    void* cand, void* win, void* lo, void* key_g, void* id_g,
                    void* out_d, void* out_i, void* stream) {
  if (b == 0 || k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e;
  if (n_take > LONGEST) {
    if (nt != LONGEST || win == nullptr || lo == nullptr)
      return (int)cudaErrorInvalidValue;
    e = select_rounds(segpack, n_live, n_slots, spt, bpad, b, n_chunks,
                      chunk_rows, n_take, cand, static_cast<int32_t*>(win),
                      static_cast<u64*>(lo), st);
  } else {
    switch (nt) {
      case 16:
        e = launch_segsel<16, 4>(segpack, n_live, n_slots, spt, bpad, b,
                                 n_chunks, chunk_rows, nullptr, cand, st);
        break;
      case 32:
        e = launch_segsel<32, 2>(segpack, n_live, n_slots, spt, bpad, b,
                                 n_chunks, chunk_rows, nullptr, cand, st);
        break;
      case 64:
        e = launch_segsel<64, 1>(segpack, n_live, n_slots, spt, bpad, b,
                                 n_chunks, chunk_rows, nullptr, cand, st);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    win = nullptr;
  }
  if (e != 0) return e;
  const int k_eff = min(k, n_take * seg);
  return launch(ivf_rescore_kernel, dim3(b),
                rescore_smem_bytes(d, n_take, seg, n_chunks,
                                   key_g != nullptr), st,
                static_cast<const u64*>(cand), nt, n_chunks,
                static_cast<const int32_t*>(win), static_cast<u64*>(key_g),
                static_cast<int32_t*>(id_g),
                static_cast<const int32_t*>(n_live),
                static_cast<const int32_t*>(sel),
                static_cast<const int32_t*>(rowids),
                static_cast<const int32_t*>(seg_cell),
                static_cast<const int16_t*>(dec16),
                static_cast<const float*>(srow16),
                static_cast<const float*>(nrm_col), dsq_min,
                static_cast<const float*>(q), static_cast<const float*>(q_sq),
                static_cast<const float*>(coarse_ip),
                static_cast<const bool*>(probed), b, n_slots, spt, seg,
                n_rows, d, kc, n_take, k, k_eff, exact_probe != 0,
                static_cast<float*>(out_d), static_cast<int32_t*>(out_i));
}

}  // extern "C"
