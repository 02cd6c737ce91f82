// The fine level of the vocabulary tree's descent on uint8 rows and an
// integer tree, for Hopper (sm_90a).
//
// Replaces no TPU kernel: cvt_tpu descends the tree in jnp (a gather of
// each point's cell block and an einsum, `_hier_assign_chunk` in
// cvt_tpu/ops/kmeans.py), and so did the port (`_cell_argmin` in
// ops/kmeans.py: float32 batched GEMMs over tiles of pairs, then a min
// reduce). Where the rows are uint8 and every fine word an integer in
// 0-255, every product and sum is an integer, and this kernel computes
// them exactly on the int8 tensor cores.
//
// What it computes (the twin's contract, `vocab_descend_plain` in
// ops/kernels/vocab_descend.py). The (point, probe) pairs p = point *
// probes + probe come sorted by cell in `order`; tile t covers
// order[first, first + count), count <= 512 pairs of one cell. For every
// pair, against its cell's K2 words f (uint8 [K2, d]) with fsq = ||f||^2:
//     out_d[p] = min_j fsq[j] - 2 <x, f_j>,  out_s[p] = the first such j
// (ties go to the lowest j, as torch.min does). |<x, f>| <= 255^2 d, so
// with d <= 128 everything fits int32 exactly.
//
// Design. One block a tile, two warpgroups. The block copies its cell's
// word block (K2 x 128 B, 128 KB at K2 1,024) and its pairs' rows (at most
// 512 x 128 B, gathered through `order`) into shared memory by cp.async,
// both in hopper_int8.cuh's swizzled K-major layout, d zero-padded to the
// k-steps. Each warpgroup then takes 64-pair M-tiles in turn and runs,
// for each 128-word chunk, d / 32 wgmma m64n128k32 u8.u8 into 64 int32
// registers a thread; the two warpgroups overlap one's epilogue with the
// other's products. The epilogue keeps the scores in registers: with
// key[j] = (fsq[j] + OFF) << 7 | (j & 127) precomputed in shared memory
// (OFF = 2 * 255^2 * 128 makes every score non-negative), key[j] - 256
// <x, f_j> is one IMAD and orders a chunk's words by (score, j), so its
// first minimum is one unsigned min a value. Across chunks a thread keeps
// (score, j) and takes a later chunk only on a strictly smaller score;
// two shuffles take the quad's lexicographic minimum, and one lane writes
// the pair's (score, j). Nothing but those 8 bytes a pair goes out.
// What bounds it: the int8 tensor-core rate (2 K2 d operations a pair),
// then the word blocks read once a tile (mostly from L2: a cell's tiles
// run side by side).

#include <cstdint>

#include <cuda_runtime.h>

#include "hopper_int8.cuh"

namespace {

using namespace hopper_int8;

constexpr int TILE = 512;            // pairs a tile at most
constexpr int NWG = 2;               // warpgroups a block
constexpr int BLOCK = NWG * THREADS;
constexpr int MAX_D = PANEL;         // one swizzled panel of K
constexpr int MAX_K2 = 1024;
// 2 * 255^2 * MAX_D: the largest 2 <x, f>, so fsq - 2 <x, f> + OFF >= 0
constexpr uint32_t OFF = 2u * 255u * 255u * MAX_D;

size_t smem_bytes(int k2) {
  return 1024 + (size_t)k2 * PANEL + (size_t)TILE * PANEL +
         (size_t)k2 * sizeof(uint32_t) + (size_t)TILE * sizeof(int);
}

// Queue the copy of a [n, d] uint8 block into n swizzled 128-byte rows,
// the 16-byte chunks past d (up to the k-steps' 32 * nk bytes) zeroed;
// src(r) gives row r's first byte.
template <class Src>
__device__ __forceinline__ void load_rows(uint8_t* dst, int n, int d,
                                          Src src) {
  const int cpr = d / 16, kpad = 2 * n_ksteps(d);
  for (int i = threadIdx.x; i < n * kpad; i += BLOCK) {
    const int r = i / kpad, c = i - r * kpad;
    uint8_t* to = dst + r * PANEL + ((c ^ (r & 7)) << 4);
    if (c < cpr)
      cp_async16(to, src(r) + 16 * c);
    else
      *reinterpret_cast<uint4*>(to) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(BLOCK, 1) vocab_descend_kernel(
    const uint8_t* __restrict__ rows, int d, int probes,
    const int64_t* __restrict__ order, const int32_t* __restrict__ tiles,
    const uint8_t* __restrict__ words, const int32_t* __restrict__ fsq,
    int k2, int32_t* __restrict__ out_d, int32_t* __restrict__ out_s) {
  extern __shared__ unsigned char smem_raw[];
  uint8_t* words_s = align1024(smem_raw);
  uint8_t* rows_s = words_s + (size_t)k2 * PANEL;
  uint32_t* key_s = reinterpret_cast<uint32_t*>(rows_s + TILE * PANEL);
  int* pair_s = reinterpret_cast<int*>(key_s + k2);

  const int cell = tiles[3 * blockIdx.x];
  const int first = tiles[3 * blockIdx.x + 1];
  const int n = tiles[3 * blockIdx.x + 2];
  const uint8_t* wsrc = words + (size_t)cell * k2 * d;
  load_rows(words_s, k2, d,
            [=](int r) { return wsrc + (size_t)r * d; });
  load_rows(rows_s, n, d, [=](int r) {
    return rows + (size_t)(order[first + r] / probes) * d;
  });
  cp_async_commit();
  for (int r = threadIdx.x; r < n; r += BLOCK)
    pair_s[r] = static_cast<int>(order[first + r]);
  for (int j = threadIdx.x; j < k2; j += BLOCK)
    key_s[j] = ((static_cast<uint32_t>(fsq[(size_t)cell * k2 + j]) + OFF)
                << 7) | (j & 127);
  cp_async_wait<0>();
  fence_async_smem();
  __syncthreads();

  const int wg = threadIdx.x / THREADS, warp = (threadIdx.x % THREADS) >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int nk = n_ksteps(d), nm = (n + QT - 1) / QT, nc = k2 / ROWS;
  int acc[64];
  for (int m = wg; m < nm; m += NWG) {
    const uint8_t* a = rows_s + m * QT * PANEL;
    // rows 16 warp + g + 8 h of the M-tile: (score + OFF, word) so far
    uint32_t bv[2] = {UINT32_MAX, UINT32_MAX};
    int bi[2] = {0, 0};
    for (int c = 0; c < nc; ++c) {
      const uint8_t* b = words_s + c * ROWS * PANEL;
      wgmma_fence();
      for (int kk = 0; kk < nk; ++kk)
        wgmma_u8(acc, make_desc(a + 32 * kk), make_desc(b + 32 * kk),
                 kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      // acc[4 j + 2 h + e]: row 16 warp + g + 8 h, word 8 j + 2 tig + e
      const uint32_t* kc = key_s + c * ROWS;
      uint32_t mn[2] = {UINT32_MAX, UINT32_MAX};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint2 kv = *reinterpret_cast<const uint2*>(kc + 8 * j + 2 * tig);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mn[h] = min(mn[h], kv.x - 256u * static_cast<uint32_t>(
                                           acc[4 * j + 2 * h]));
          mn[h] = min(mn[h], kv.y - 256u * static_cast<uint32_t>(
                                           acc[4 * j + 2 * h + 1]));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t v = mn[h] >> 7;
        if (v < bv[h]) {
          bv[h] = v;
          bi[h] = c * ROWS + static_cast<int>(mn[h] & 127);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int s = 1; s <= 2; s <<= 1) {
        const uint32_t ov = __shfl_xor_sync(0xffffffffu, bv[h], s);
        const int oi = __shfl_xor_sync(0xffffffffu, bi[h], s);
        if (ov < bv[h] || (ov == bv[h] && oi < bi[h])) {
          bv[h] = ov;
          bi[h] = oi;
        }
      }
      const int r = m * QT + 16 * warp + g + 8 * h;
      if (tig == 0 && r < n) {
        const int p = pair_s[r];
        out_d[p] = static_cast<int32_t>(bv[h]) - static_cast<int32_t>(OFF);
        out_s[p] = bi[h];
      }
    }
  }
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (vocab_descend): contiguous
// tensors, rows uint8 [T, d], order int64 [n] (values below T * probes
// and 2^31), tiles int32 [n_tiles, 3] (cell, first, count), words uint8
// [K1, k2, d], fsq int32 [K1, k2], out_d / out_s int32 [n]; d a multiple
// of 16 up to 128, k2 a multiple of 128 up to 1,024. Returns 0 or the
// cudaError_t of the launch.
int cvt_vocab_descend(const void* rows, int d, int probes, const void* order,
                      const void* tiles, int n_tiles, const void* words,
                      const void* fsq, int k2, void* out_d, void* out_s,
                      void* stream) {
  if (n_tiles == 0) return 0;
  if (d <= 0 || d > MAX_D || d % 16 || k2 <= 0 || k2 > MAX_K2 ||
      k2 % ROWS || probes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k2);
  cudaError_t e = cudaFuncSetAttribute(
      vocab_descend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  vocab_descend_kernel<<<n_tiles, BLOCK, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), d, probes,
      static_cast<const int64_t*>(order), static_cast<const int32_t*>(tiles),
      static_cast<const uint8_t*>(words), static_cast<const int32_t*>(fsq),
      k2, static_cast<int32_t*>(out_d), static_cast<int32_t*>(out_s));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
