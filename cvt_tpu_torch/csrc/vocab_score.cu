// Inverted-file scoring of the vocabulary tree with 64-bit Hamming
// embedding, for Hopper (sm_90a).
//
// Replaces no TPU kernel: cvt_tpu scores a query batch in jnp (a gather of
// each query word's padded bucket, and a word-equality mask over the
// bucket overflow), and so did the port (`_score_query_many` in
// index/vocab_he.py). This kernel walks cvt's own per-word lists
// (inverted_file.h) in CSR form and scores only the real pairs.
//
// What it computes (the twin's contract, `vocab_score_plain` in
// ops/kernels/vocab_score.py). Query feature f (word w = f_word[f], -1 for
// none; signature f_sig[f]; query f_query[f]) meets each entry e of word
// w's list, offsets[w] <= e < offsets[w + 1] (image e_img[e], signature
// e_sig[e], burstiness weight e_burst[e]). With h = popcount(f_sig[f] ^
// e_sig[e]) and h <= max_dist it adds
//     float32((wtab[h] * (idf[w] * idf[w])) * e_burst[e])
// to out[f_query[f], e_img[e]] in float64 (inverted_file.h:295-353, with
// wtab[h] = exp(-h^2 / sigma^2) made by the caller, utils.h:52-83). The
// terms are the twin's bitwise; float64 partial sums make the float32
// rounding of the result independent of the order in which the atomics
// land, bar a sum within ~1e-13 of a rounding boundary.
//
// Work split. cum[f] is the inclusive prefix sum of the list lengths (0
// for f_word < 0), so pair p belongs to the first f with cum[f] > p. A
// fixed grid strides over the pairs; each thread finds its pair's feature
// by a binary search of cum, so one long list is spread over every block
// as the short ones are. Consecutive threads take consecutive pairs,
// which mostly lie in one list: their entry loads coalesce and their
// searches read the same lines. The [Q, n_images] float64 block of a
// 64-image batch over 5,062 images is 2.6 MB and stays in L2, where the
// atomics land. What bounds it: the entries' bytes (12 a pair: signature
// and image) and the atomics of the pairs within max_dist.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_DIST = 64;

__global__ void __launch_bounds__(THREADS) vocab_score_kernel(
    const int32_t* __restrict__ f_word, const int64_t* __restrict__ f_sig,
    const int32_t* __restrict__ f_query, const int64_t* __restrict__ cum,
    int n_feat, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ e_img, const int64_t* __restrict__ e_sig,
    const float* __restrict__ e_burst, const float* __restrict__ idf,
    const float* __restrict__ wtab, int max_dist, int n_images,
    double* __restrict__ out) {
  __shared__ float weight[MAX_DIST + 1];
  for (int i = threadIdx.x; i <= max_dist; i += blockDim.x) weight[i] = wtab[i];
  __syncthreads();
  const int64_t total = cum[n_feat - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       p < total; p += stride) {
    int lo = 0, hi = n_feat - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (cum[mid] > p) hi = mid; else lo = mid + 1;
    }
    // f_word[lo] >= 0: a feature without a word has an empty list
    const int w = f_word[lo];
    const int64_t e = offsets[w] + (p - (lo ? cum[lo - 1] : 0));
    const int h = __popcll(static_cast<unsigned long long>(f_sig[lo] ^
                                                           e_sig[e]));
    if (h > max_dist) continue;
    const float idf_w = idf[w];
    const float term = (weight[h] * (idf_w * idf_w)) * e_burst[e];
    atomicAdd(out + static_cast<int64_t>(f_query[lo]) * n_images + e_img[e],
              static_cast<double>(term));
  }
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (vocab_score): contiguous
// tensors, f_word / f_query int32 and f_sig / cum int64 of n_feat
// entries, offsets int64 [W + 1], e_img int32, e_sig int64, e_burst, idf,
// wtab float32 with max_dist + 1 <= 65 entries, out float64 [Q, n_images]
// zeroed. Returns 0 or the cudaError_t of the launch.
int cvt_vocab_score(const void* f_word, const void* f_sig,
                    const void* f_query, const void* cum, int n_feat,
                    const void* offsets, const void* e_img,
                    const void* e_sig, const void* e_burst, const void* idf,
                    const void* wtab, int max_dist, int n_images, int blocks,
                    void* out, void* stream) {
  if (n_feat == 0) return 0;
  if (max_dist < 0 || max_dist > MAX_DIST || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  vocab_score_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f_word),
      static_cast<const int64_t*>(f_sig),
      static_cast<const int32_t*>(f_query),
      static_cast<const int64_t*>(cum), n_feat,
      static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(e_img),
      static_cast<const int64_t*>(e_sig),
      static_cast<const float*>(e_burst), static_cast<const float*>(idf),
      static_cast<const float*>(wtab), max_dist, n_images,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
