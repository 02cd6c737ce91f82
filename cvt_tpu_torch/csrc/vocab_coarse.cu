// The coarse level of the vocabulary tree's descent: each point's P
// nearest coarse cells, for Hopper (sm_90a).
//
// Replaces no TPU kernel: cvt_tpu takes the coarse top P in jnp
// (`_hier_assign_chunk` in cvt_tpu/ops/kmeans.py: the [T, K1] distance
// matrix, then lax.top_k), and so did the port (`vocab_coarse_plain` in
// ops/kernels/vocab_coarse.py: a float32 GEMM, the [T, K1] matrix in
// device memory and a full stable sort of every row, to keep P of K1).
//
// What it computes (the twin's contract). Points x float32 [T, d]; the K1
// centres come transposed and zero-padded as ct [dp, k1p] (dp = d rounded
// up to 16, k1p = K1 rounded up to 128) with csq [k1p] = ||c||^2. Row t's
// distance to centre j is the twin's float32 expression, each step
// rounded as the twin rounds it:
//     dist[t, j] = (||x_t||^2 - 2 <x_t, c_j>) + csq[j]
// with <x_t, c_j> one chain of FMAs over k = 0..d-1 (the twin's GEMM sums
// in another order: the two agree bitwise wherever every product and
// partial sum is exact, integer-valued points and centres for one, and
// within a float32 summation bound elsewhere). Out: the row's first P
// cells in (dist, j) order and their distances, ties to the lower j, as
// the twin's stable sort (and lax.top_k) give them. Nothing of [T, K1]
// reaches device memory: 12 P bytes a row go out.
//
// What bounds it: FP32 FMAs, T K1 d of them (2 T K1 d operations; at the
// vocabulary cell's batch, 206k x 1,024 x 128, ~0.8 ms at the card's 67
// TFLOP/s). No tensor core computes a float32 product exactly (TF32
// rounds the inputs), so the products run on the FMA units.
//
// Design. A block owns 128 rows for all of K1: their [dp, 128] slice of
// x sits transposed in shared memory once, and the centres stream
// through a ring of three [16, 128] slices of ct by cp.async, two ahead.
// 256 threads as 16 x 16; thread (ty, tx) keeps an 8 x 8 tile of dot
// products in registers, rows {4 ty.., 64 + 4 ty..} by centres {4 tx..,
// 64 + 4 tx..} of the current block of 128 centres, and reads its 8 + 8
// operands a k-step as four 16-byte shared loads.
//
// The selection. A row's 128 centres of a block lie in the 16 lanes of
// one half-warp (tid = 16 ty + tx), and so does its running list in
// shared memory, lane tx holding entry tx of the row's best 16 so far in
// (dist, j) order (P <= 16 are read out). After each centre block a
// thread forms its 64 distances and marks those not above its row's
// bound: the list's P-th entry, and in the first block, while the list
// is empty, the P-th smallest of the 16 lanes' minima (P lanes hold a
// distance at most that, so the row's P-th best is no larger; a bitonic
// sort over the half-warp finds it). Each half-warp then inserts its
// marked candidates one a round, its lowest lane's lowest first: each
// lane compares the candidate with its entry (strict <, lexicographic on
// (dist, j)) and takes its left neighbour's entry or the candidate by
// one shuffle up, so the list stays sorted, the last entry drops out and
// a tie goes to the lower j; a candidate that no longer makes the list
// drops out too. A row takes ~26 insertions for P = 8 over K1 = 1,024;
// once the list fills nearly every distance lies above its bound, and
// the selection costs a compare a distance against the 128 FMAs it took.
// (The selection still costs ~40% on top of the products at the cell's
// shape: its insertions are chains of shuffles.)

#include <climits>
#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

#include "hopper_int8.cuh"

namespace {

using hopper_int8::cp_async16;
using hopper_int8::cp_async_commit;
using hopper_int8::cp_async_wait;

constexpr int BM = 128;      // rows a block
constexpr int BN = 128;      // centres a block step
constexpr int BK = 16;       // k a ring slice
constexpr int NST = 3;       // ring slices
constexpr int THREADS = 256;
constexpr int MAX_D = 128;
constexpr int MAX_P = 16;    // the list's length: a half-warp
constexpr unsigned FULL = 0xffffffffu;

size_t smem_bytes(int dp) {
  return ((size_t)dp * BM + (size_t)NST * BK * BN + BM + 2 * BM * MAX_P) *
         sizeof(float);
}

// Put candidate (cd, cj), the same in all 16 lanes of a half-warp, into
// the half-warp's sorted list (lane tx holds entry tx); the last entry
// drops out. Lanes whose entry the candidate goes before take their left
// neighbour's entry, the first of them the candidate.
__device__ __forceinline__ void insert(float& ld, int& lj, float cd, int cj,
                                       int tx) {
  const bool before = cd < ld || (cd == ld && cj < lj);
  const float pd = __shfl_up_sync(FULL, ld, 1, 16);
  const int pj = __shfl_up_sync(FULL, lj, 1, 16);
  const int pbefore = __shfl_up_sync(FULL, static_cast<int>(before), 1, 16);
  if (before) {
    const bool first = tx == 0 || !pbefore;
    ld = first ? cd : pd;
    lj = first ? cj : pj;
  }
}

__global__ void __launch_bounds__(THREADS, 2) vocab_coarse_kernel(
    const float* __restrict__ x, int t, int d, const float* __restrict__ ct,
    const float* __restrict__ csq, int k1, int k1p, int p,
    float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);       // [dp][BM]
  const int dp = (d + BK - 1) / BK * BK;
  float* cs = xs + (size_t)dp * BM;                  // [NST][BK][BN]
  float* xsq_s = cs + NST * BK * BN;                 // [BM]
  float* list_d = xsq_s + BM;                        // [BM][MAX_P]
  int* list_j = reinterpret_cast<int*>(list_d + BM * MAX_P);

  const int tid = threadIdx.x, lane = tid & 31;
  const int ty = tid >> 4, tx = tid & 15, hb = lane & 16;
  const int row0 = blockIdx.x * BM;
  const int kc_n = dp / BK, steps = (k1p / BN) * kc_n;

  // slice s of the ring: k rows kc * BK.. of centre block nb
  auto load_slice = [&](int s) {
    const int nb = s / kc_n, kc = s - nb * kc_n;
    float* dst = cs + (s % NST) * BK * BN;
    const float* src = ct + (size_t)kc * BK * k1p + nb * BN;
    for (int i = tid; i < BK * BN / 4; i += THREADS) {
      const int r = i / (BN / 4), c = 4 * (i % (BN / 4));
      cp_async16(dst + r * BN + c, src + (size_t)r * k1p + c);
    }
  };
  for (int s = 0; s < NST - 1; ++s) {
    if (s < steps) load_slice(s);
    cp_async_commit();
  }
  // the rows' x, transposed; k >= d and rows >= t are zero
  for (int i = tid; i < BM * (dp / 4); i += THREADS) {
    const int r = i % BM, k = 4 * (i / BM);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < t && k < d)
      v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(row0 + r) * d +
                                                k));
    xs[(k + 0) * BM + r] = v.x;
    xs[(k + 1) * BM + r] = v.y;
    xs[(k + 2) * BM + r] = v.z;
    xs[(k + 3) * BM + r] = v.w;
  }
  __syncthreads();
  if (tid < BM) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      const float v = xs[k * BM + tid];
      s = __fadd_rn(s, __fmul_rn(v, v));
    }
    xsq_s[tid] = s;
  }
  for (int i = tid; i < BM * MAX_P; i += THREADS) {
    list_d[i] = INFINITY;
    list_j[i] = INT_MAX;
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;

  for (int s = 0; s < steps; ++s) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // slice s has landed; every thread is done with s - 1
    if (s + NST - 1 < steps) load_slice(s + NST - 1);
    cp_async_commit();
    const int nb = s / kc_n, kc = s - nb * kc_n;
    const float* cb = cs + (s % NST) * BK * BN;
    const float* xb = xs + (size_t)kc * BK * BM;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xb + k * BM + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(xb + k * BM + 64 + 4 * ty);
      const float4 b0 = *reinterpret_cast<const float4*>(cb + k * BN + 4 * tx);
      const float4 b1 =
          *reinterpret_cast<const float4*>(cb + k * BN + 64 + 4 * tx);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[i][e] = fmaf(a[i], b[e], acc[i][e]);
    }
    if (kc != kc_n - 1) continue;

    // centre block nb is summed: its distances into the rows' lists
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // row r's list: lane tx of its half-warp holds entry tx
      const int r = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
      const float xq = xsq_s[r];
      float ld = list_d[r * MAX_P + tx];
      int lj = list_j[r * MAX_P + tx];
      float bound = __shfl_sync(FULL, ld, hb + p - 1);
      float v[8];
      float m = INFINITY;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = nb * BN + (e < 4 ? 0 : 64) + 4 * tx + (e & 3);
        v[e] = __fadd_rn(__fsub_rn(xq, 2.f * acc[i][e]), __ldg(csq + j));
        acc[i][e] = 0.f;
        if (j < k1) m = fminf(m, v[e]);
      }
      if (nb == 0) {  // the P-th smallest lane minimum, by a bitonic sort
#pragma unroll
        for (int k = 2; k <= 16; k <<= 1)
#pragma unroll
          for (int jj = k >> 1; jj > 0; jj >>= 1) {
            const float o = __shfl_xor_sync(FULL, m, jj);
            m = (((tx & jj) == 0) == ((tx & k) == 0)) ? fminf(m, o)
                                                       : fmaxf(m, o);
          }
        bound = fminf(bound, __shfl_sync(FULL, m, hb + p - 1));
      }
      // this lane's candidates not above the bound, by e
      unsigned pm = 0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int j = nb * BN + (e < 4 ? 0 : 64) + 4 * tx + (e & 3);
        if (j < k1 && v[e] <= bound) pm |= 1u << e;
      }
      unsigned b = __ballot_sync(FULL, pm != 0);
      while (b) {
        const unsigned mine = (b >> hb) & 0xffffu;
        const int src = hb + (mine ? __ffs(mine) - 1 : 0);
        const int e = __ffs(pm) - 1;
        float cv = v[0];
#pragma unroll
        for (int q = 1; q < 8; ++q) cv = e == q ? v[q] : cv;
        float cd = __shfl_sync(FULL, cv, src);
        int cj = __shfl_sync(FULL, nb * BN + (e < 4 ? 0 : 64) + 4 * tx +
                                       (e & 3), src);
        if (!mine) {  // nothing left in this half-warp: insert nothing
          cd = INFINITY;
          cj = INT_MAX;
        }
        insert(ld, lj, cd, cj, tx);
        if (lane == src) pm &= pm - 1;
        b = __ballot_sync(FULL, pm != 0);
      }
      list_d[r * MAX_P + tx] = ld;
      list_j[r * MAX_P + tx] = lj;
    }
  }

  // each thread writes its own rows' entries: no barrier needed
  if (tx < p) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = (i < 4 ? 0 : 64) + 4 * ty + (i & 3);
      if (row0 + r < t) {
        out_d[(size_t)(row0 + r) * p + tx] = list_d[r * MAX_P + tx];
        out_i[(size_t)(row0 + r) * p + tx] = list_j[r * MAX_P + tx];
      }
    }
  }
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (vocab_coarse): x contiguous
// float32 [t, d], 16-byte aligned, d a multiple of 4 up to 128; ct float32
// [dp, k1p] and csq float32 [k1p], zero past d and k1 (dp = d rounded up
// to 16, k1p = k1 rounded up to 128); 1 <= p <= 16, p <= k1;
// out_d float32 and out_i int64 [t, p]. Returns 0 or the cudaError_t of
// the launch.
int cvt_vocab_coarse(const void* x, int t, int d, const void* ct,
                     const void* csq, int k1, int p, void* out_d,
                     void* out_i, void* stream) {
  if (t == 0) return 0;
  if (t < 0 || d <= 0 || d > MAX_D || d % 4 || p < 1 || p > MAX_P ||
      k1 < p)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dp = (d + BK - 1) / BK * BK, k1p = (k1 + BN - 1) / BN * BN;
  const size_t smem = smem_bytes(dp);
  cudaError_t e = cudaFuncSetAttribute(
      vocab_coarse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  vocab_coarse_kernel<<<(t + BM - 1) / BM, THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), t, d, static_cast<const float*>(ct),
      static_cast<const float*>(csq), k1, k1p, p,
      static_cast<float*>(out_d), static_cast<int64_t*>(out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
