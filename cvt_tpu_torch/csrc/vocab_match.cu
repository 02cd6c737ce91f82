// Candidate matches of the vocabulary tree's spatial verification, over
// the inverted file, for Hopper (sm_90a).
//
// Replaces no TPU kernel: cvt_tpu verifies a candidate by a dense
// [C, Kq, Ki] word-equality and Hamming mask between the query's features
// and the candidate's padded entry table (`_verify_candidates` in
// index/vocab_he.py), which at Oxford5k's size (Ki up to 10,000) cannot be
// built. This kernel walks cvt's own per-word lists (inverted_file.h) in
// CSR form, as vocab_score_kernel does, and keeps only the pairs whose
// image is one of the query's candidates.
//
// What it computes (the twin's contract, `vocab_match_plain` in
// ops/kernels/vocab_match.py). Query feature f (word w = f_word[f], -1 for
// none; signature f_sig[f]; query f_query[f]) meets each entry e of word
// w's list, offsets[w] <= e < offsets[w + 1] (image e_img[e], signature
// e_sig[e], database feature e_feat[e]). Where s = cand[f_query[f] *
// n_images + e_img[e]] >= 0 (the slot of a (query, candidate image) pair)
// and h = popcount(f_sig[f] ^ e_sig[e]) <= max_dist, it emits the record
// {s, f, e_feat[e], h}. Records land in the order their warps' atomics
// do; the caller sorts them. `count` ends as the number of records, also
// past `capacity`, where no record is written: the caller launches again
// with room for them all.
//
// Work split: vocab_score_kernel's. cum[f] is the inclusive prefix sum of
// the list lengths; a fixed grid strides over the batch's pairs, each
// thread finds its pair's feature by a binary search of cum. The image is
// read first and the candidate table (a [Q, n_images] int32 table of a
// 64-image batch is 1.3 MB, L2-resident) decides whether the signature and
// the feature id are read at all. Each warp takes the places of its
// records with one atomic on `count` (a ballot and a prefix count of its
// lanes), and each record is one 16-byte store. What bounds it: the
// entries' images (4 bytes a pair walked), the candidates' signatures and
// ids, and the records written.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) vocab_match_kernel(
    const int32_t* __restrict__ f_word, const int64_t* __restrict__ f_sig,
    const int32_t* __restrict__ f_query, const int64_t* __restrict__ cum,
    int n_feat, const int64_t* __restrict__ offsets,
    const int32_t* __restrict__ e_img, const int64_t* __restrict__ e_sig,
    const int32_t* __restrict__ e_feat, const int32_t* __restrict__ cand,
    int n_images, int max_dist, int64_t capacity,
    unsigned long long* __restrict__ count, int4* __restrict__ out) {
  const int64_t total = cum[n_feat - 1];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  // `base` is the same for every thread of a block, so whole warps run
  // each round together and may ballot
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
       base < total; base += stride) {
    const int64_t p = base + threadIdx.x;
    bool keep = false;
    int4 rec;
    if (p < total) {
      int lo = 0, hi = n_feat - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] > p) hi = mid; else lo = mid + 1;
      }
      // f_word[lo] >= 0: a feature without a word has an empty list
      const int64_t e = offsets[f_word[lo]] + (p - (lo ? cum[lo - 1] : 0));
      const int slot = cand[static_cast<int64_t>(f_query[lo]) * n_images +
                            e_img[e]];
      if (slot >= 0) {
        const int h = __popcll(static_cast<unsigned long long>(f_sig[lo] ^
                                                               e_sig[e]));
        if (h <= max_dist) {
          keep = true;
          rec = make_int4(slot, lo, e_feat[e], h);
        }
      }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (mask == 0) continue;
    const int leader = __ffs(mask) - 1;
    unsigned long long first = 0;
    if (lane == leader)
      first = atomicAdd(count, static_cast<unsigned long long>(__popc(mask)));
    first = __shfl_sync(0xffffffffu, first, leader);
    if (keep) {
      const unsigned long long at =
          first + __popc(mask & ((1u << lane) - 1u));
      if (at < static_cast<unsigned long long>(capacity)) out[at] = rec;
    }
  }
}

}  // namespace

extern "C" {

// Shapes are validated by the Python wrapper (vocab_match): contiguous
// tensors, f_word / f_query int32 and f_sig / cum int64 of n_feat
// entries, offsets int64 [W + 1], e_img / e_feat int32 and e_sig int64 of
// one length, cand int32 [Q, n_images], count one zeroed uint64, out int32
// [capacity, 4]. Returns 0 or the cudaError_t of the launch.
int cvt_vocab_match(const void* f_word, const void* f_sig,
                    const void* f_query, const void* cum, int n_feat,
                    const void* offsets, const void* e_img,
                    const void* e_sig, const void* e_feat, const void* cand,
                    int n_images, int max_dist, int capacity, int blocks,
                    void* count, void* out, void* stream) {
  if (n_feat == 0) return 0;
  if (max_dist < 0 || max_dist > 64 || capacity < 0 || blocks <= 0 ||
      n_images <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  vocab_match_kernel<<<blocks, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(f_word),
      static_cast<const int64_t*>(f_sig),
      static_cast<const int32_t*>(f_query),
      static_cast<const int64_t*>(cum), n_feat,
      static_cast<const int64_t*>(offsets),
      static_cast<const int32_t*>(e_img),
      static_cast<const int64_t*>(e_sig),
      static_cast<const int32_t*>(e_feat),
      static_cast<const int32_t*>(cand), n_images, max_dist, capacity,
      static_cast<unsigned long long*>(count), static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
