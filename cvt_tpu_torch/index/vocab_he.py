"""Visual-word index with Hamming embedding and TF-IDF scoring
(counterpart of `cvt_tpu.index.vocab_he`).

Reference: retrieval/vlindex/src/retrieval/ — `VisualIndex<uint8_t,128,64>`
(visual_index.h:59-183): hierarchical k-means vocabulary (Build,
:624-665), 64-bit Hamming-embedding projection + per-word median
thresholds (inverted_index.h:174-183, inverted_file.h:276-292), `Query`
scoring with exp(-h^2/sigma^2) weights x idf^2 and burstiness
/sqrt(votes) (inverted_file.h:295-353, utils.h:52-83), self-similarity
normalization (inverted_index.h:238-288), and query-time spatial
verification: Hamming matching -> 1-to-1 match selection -> vote and
verify (visual_index.h:376-501).

What differs from `cvt_tpu`:
  * a 64-bit signature is one int64 word: bits 0-31 are `cvt_tpu`'s
    uint32 word 0, bits 32-63 its word 1 (`save`, `load` and
    `convert.vocab_he_from_numpy` convert to and from [..., 2] uint32),
    counted by `ops/bits.py`'s byte table (torch has no popcount);
  * queries are scored from an inverted file in CSR form (each word's
    list of entries, cvt's inverted_file.h), built from the persisted
    bucket layout: only the real pairs of a query feature and an entry
    of its word are scored (`ops/kernels/vocab_score.py`: the CUDA kernel
    `vocab_score_kernel` on the card, its twin on the CPU). Float32 terms
    are added into a float64 buffer, rounded to float32 once at the end.
    On the card the atomics add in whatever order they land; with float64
    partial sums the rounded result is the same on every run, and the
    same as the CPU's sum of the same terms, bar a sum within ~1e-13 of a
    float32 rounding boundary. The self-similarities (from the (word,
    image) groups, in `prepare`) and a query's idf^2 sum are float64 sums
    rounded once as well. Against `cvt_tpu`'s float32 sums in XLA's
    order, scores agree to a tolerance and ids where neighbouring scores
    are further apart;
  * the ragged `query_batch` verifies its candidates without padded
    tables: their matches come from the inverted file
    (`ops/kernels/vocab_match.py`), the 1-to-1 rule runs on the sorted
    records and vote-and-verify on one flat match list, its affine fits
    solved in float64 (`match/vote_verify.py`); the padded form keeps
    `cvt_tpu`'s dense tensors and float32 fits;
  * `train` draws its vocabulary seeds and its HE projection from a CPU
    `torch.Generator`, so a trained index differs from `cvt_tpu`'s for the
    same seed; the host-side layout (medians, buckets, tail, idf,
    burstiness) is `cvt_tpu`'s numpy code and gives the same arrays from
    the same words and signatures.

A loaded index raises on `add_image`, as `cvt_tpu`'s does: its entries
are baked into the prepared layout (`cvt_tpu/cli.py:316` trips on this).
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.match.vote_verify import (vote_and_verify,
                                             vote_and_verify_segmented)
from cvt_tpu_torch.ops.kmeans import (hierarchical_assign,
                                      hierarchical_kmeans, integer_tree,
                                      kmeans, kmeans_assign,
                                      kmeans_assign_blocked)
from cvt_tpu_torch.ops.bits import (_hamming, _pack_bits, _popcount,  # noqa: F401
                                    sigs_from_u32, sigs_to_u32)
from cvt_tpu_torch.ops.kernels.vocab_match import vocab_match
from cvt_tpu_torch.ops.kernels.vocab_score import vocab_score
from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.utils.device import resolve_device
from cvt_tpu_torch.utils.profile import span

HE_BITS = 64
HE_MAX_DIST = 24       # visual_index.h max Hamming distance
HE_SIGMA = 16.0        # utils.h HammingDistWeightFunctor sigma
_ADD_ROWS = 1 << 18    # descriptors `add_images` encodes a step
_SELF_PAIRS = 1 << 24  # entry pairs a self-similarity step sums
# the prepared layout's arrays that stay on the host: the persisted bucket
# and tail form, which `save` writes and the inverted file is built from
_HOST_LAYOUT = ("b_img", "b_sig", "b_burst", "t_word", "t_img", "t_sig",
                "t_burst")


def _he_weight(h: torch.Tensor) -> torch.Tensor:
    """exp(-h^2/sigma^2), zeroed beyond HE_MAX_DIST (utils.h:52-83)."""
    w = torch.exp(-(h.to(torch.float32) ** 2) / (HE_SIGMA ** 2))
    return torch.where(h <= HE_MAX_DIST, w, 0.0)


def _score_query_many(q_words, q_sigs, q_valid, buckets_img, buckets_sig,
                      buckets_burst, tail_word, tail_img, tail_sig,
                      tail_burst, idf, n_images: int, tail_tc: int = 32768):
    """Batched scoring: q_words [Q, Kq], q_sigs [Q, Kq] int64, q_valid
    [Q, Kq]; buckets_* [W, L]; tail_* [T] -> unnormalized image scores
    [Q, n_images]. The bucket pass gathers each query word's bucket; the
    tail pass scores the bucket-overflow entries exactly with a
    word-equality mask, `tail_tc` tail entries per step."""
    q = q_words.shape[0]
    wq = q_words.long()
    b_img = buckets_img[wq]                               # [Q, Kq, L]
    h = _hamming(q_sigs[..., None], buckets_sig[wq])
    idf_q2 = (idf[wq] ** 2)[..., None]                    # [Q, Kq, 1]
    w = _he_weight(h) * idf_q2 * buckets_burst[wq]
    w = torch.where((b_img >= 0) & q_valid[..., None], w, 0.0)
    base = (torch.arange(q, device=w.device) * n_images)[:, None, None]
    # float64 partial sums: the atomics' order cannot move the float32 result
    scores = torch.zeros(q * n_images, dtype=torch.float64, device=w.device)
    scores.index_add_(0, (base + torch.clamp_min(b_img, 0)).reshape(-1),
                      w.reshape(-1).double())
    for lo in range(0, tail_word.shape[0], tail_tc):
        tw_w, tw_i = tail_word[lo:lo + tail_tc], tail_img[lo:lo + tail_tc]
        th = _hamming(q_sigs[..., None], tail_sig[lo:lo + tail_tc])
        tw = _he_weight(th) * idf_q2 * tail_burst[lo:lo + tail_tc]
        keep = ((q_words[..., None] == tw_w) & (tw_i >= 0)
                & q_valid[..., None])                     # [Q, Kq, Tc]
        tw = torch.where(keep, tw, 0.0)
        t_img = (base + torch.clamp_min(tw_i, 0)).expand(tw.shape)
        scores.index_add_(0, t_img.reshape(-1), tw.reshape(-1).double())
    return scores.float().reshape(q, n_images)


def _score_one(q_words, q_sigs, q_valid, buckets_img, buckets_sig,
               buckets_burst, tail_word, tail_img, tail_sig, tail_burst,
               idf, n_images: int, tail_tc: int = 32768):
    """One query: q_words [Kq] -> unnormalized image scores [n_images]."""
    return _score_query_many(
        q_words[None], q_sigs[None], q_valid[None], buckets_img,
        buckets_sig, buckets_burst, tail_word, tail_img, tail_sig,
        tail_burst, idf, n_images, tail_tc)[0]


def _self_similarity(words, sigs, valid, idf):
    """Per-image self-scores [B] of words/sigs/valid [B, K]: for every
    same-word entry pair (i, j) within one image, w_he(hamming) * idf^2 *
    burst_j with burst_j = 1/sqrt(#same-word entries), exactly what the
    scoring pass credits an image querying itself."""
    same = ((words[:, :, None] == words[:, None, :])
            & valid[:, :, None] & valid[:, None, :])
    h = _hamming(sigs[:, :, None], sigs[:, None, :])
    wt = _he_weight(h) * (idf[words.long()] ** 2)[:, :, None]
    votes = torch.sum(same, 1).to(torch.float32)
    burst_j = torch.rsqrt(torch.clamp_min(votes, 1.0))
    return torch.sum(torch.where(same, wt * burst_j[:, None, :], 0.0),
                     (1, 2))


def _self_similarity_groups(img, sig, start, size, word, idf,
                            n_images: int):
    """Per-image self-scores [n_images] from the (word, image) groups of
    entries sorted by (word, image): img, sig [E]; each group's first
    entry `start`, `size` and `word` [G]. Only same-word pairs within an
    image count, and those are the pairs of one group: for every pair (i,
    j) of it, w_he(hamming) * idf^2 * burst_j, burst_j = 1/sqrt(size),
    the terms of `_self_similarity`, summed in float64 (at most
    `_SELF_PAIRS` pairs at a time) and rounded to float32 once."""
    dev = img.device
    n_pairs = size * size
    cum = torch.cumsum(n_pairs, 0)
    ends = cum.cpu()
    out = torch.zeros(n_images, dtype=torch.float64, device=dev)
    lo = 0
    while lo < len(ends):
        base = int(ends[lo - 1]) if lo else 0
        hi = max(lo + 1, int(torch.searchsorted(ends, base + _SELF_PAIRS,
                                                right=True)))
        n = int(ends[hi - 1]) - base
        gi = torch.repeat_interleave(torch.arange(lo, hi, device=dev),
                                     n_pairs[lo:hi], output_size=n)
        r = torch.arange(base, base + n, device=dev) - (cum[gi] - n_pairs[gi])
        g = size[gi]
        i, j = start[gi] + r // g, start[gi] + r % g
        wt = _he_weight(_hamming(sig[i], sig[j])) * idf[word[gi]] ** 2
        term = wt * torch.rsqrt(g.to(torch.float32))
        out.index_add_(0, img[start[gi]].long(), term.double())
        lo = hi
    return out.float()


def _candidate_matches(q_words, q_sigs, q_valid, c_words, c_sigs,
                       c_valid, idf):
    """The padded form's matches of queries against C candidate images
    each: q_* [..., Kq] query features, c_* [..., C, Ki] candidate entries
    (padded). Word equality + Hamming <= 24, weight = exp(-h^2/s^2) *
    idf^2; each query feature takes its best db feature (first maximum),
    each db feature keeps only its best claimant (the lowest query index
    among equal weights). -> (best_j [..., C, Kq], each query feature's
    db feature; keep [..., C, Kq], the kept matches)."""
    qw = q_words[..., None, :, None]                      # [..., 1, Kq, 1]
    same = qw == c_words[..., :, None, :]                 # [..., C, Kq, Ki]
    h = _hamming(q_sigs[..., None, :, None], c_sigs[..., :, None, :])
    wm = _he_weight(h) * (idf[q_words.long()] ** 2)[..., None, :, None]
    wm = torch.where(same & q_valid[..., None, :, None]
                     & c_valid[..., :, None, :], wm, 0.0)
    # 1-to-1: each query feature picks its best db feature ...
    best_w = torch.amax(wm, -1)                           # [..., C, Kq]
    best_j = torch.argmax(wm, -1)                         # first maximum
    # ... and each db feature keeps only the best query claiming it
    zeros = torch.zeros(wm.shape[:-2] + (c_words.shape[-1],),
                        dtype=torch.float32, device=wm.device)
    claim = zeros.scatter_reduce(-1, best_j, best_w, "amax")
    keep = (best_w > 0.0) & (best_w >= torch.gather(claim, -1, best_j))
    # break residual ties (two queries with equal weight): the first by
    # index keeps the db feature
    qi = torch.arange(q_words.shape[-1], dtype=torch.int32,
                      device=wm.device).expand(best_j.shape)
    first = torch.full(zeros.shape, 2 ** 30, dtype=torch.int32,
                       device=wm.device).scatter_reduce(
        -1, best_j, torch.where(keep, qi, 2 ** 30), "amin")
    return best_j, keep & (torch.gather(first, -1, best_j) == qi)


def _verify_candidates(q_words, q_sigs, q_valid, q_geom, c_words, c_sigs,
                       c_valid, c_geom, idf, image_extent: float):
    """Spatially verify queries against C candidate images each.

    q_*: [..., Kq(, 4)] query features; c_*: [..., C, Ki(, 4)] candidate
    entries (padded). The matches of `_candidate_matches`, then
    vote_and_verify. Returns [..., C] verification scores (effective
    inlier counts)."""
    best_j, keep = _candidate_matches(q_words, q_sigs, q_valid, c_words,
                                      c_sigs, c_valid, idf)
    g2 = torch.gather(c_geom, -2, best_j[..., None].expand(
        best_j.shape + (4,)))                             # [..., C, Kq, 4]
    g1 = q_geom[..., None, :, :].expand(g2.shape)
    return vote_and_verify(g1, g2, keep, image_extent=image_extent).score


def _runs(srt: torch.Tensor) -> torch.Tensor:
    """The run number of each element of a sorted key [M]."""
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    return torch.cumsum(new, 0) - 1


def _one_to_one(rec: torch.Tensor, n_feat: int, n_db: int):
    """`_verify_candidates`' 1-to-1 rule on match records [M, 4] int32
    (pair, query feature, database feature, Hamming distance h) in any
    order, query features < n_feat, database features < n_db -> (pair,
    query feature, database feature) int64 of the kept matches, in (pair,
    query feature) order. Each query feature of a pair takes its best
    database feature, the lowest h and then the first; each database
    feature keeps its best claimant, the lowest h and then the lowest
    query feature. The candidates of one query feature share its word and
    so its idf: the padded form's higher weight exp(-h^2/sigma^2) idf^2 is
    the lower h, and its equal weights the equal h. Minima, so the
    records' order does not move the result."""
    big = torch.iinfo(torch.int64).max
    r = rec.long()
    key, order = torch.sort(r[:, 0] * n_feat + r[:, 1])
    pair, qf, dbf, h = r[order].unbind(1)
    grp = _runs(key)
    own = (h << 31) | dbf
    chosen = own == torch.full_like(own, big).scatter_reduce(
        0, grp, own, "amin")[grp]
    key2, order2 = torch.sort(torch.where(chosen, pair * n_db + dbf, big))
    grp2 = torch.empty_like(grp)
    grp2[order2] = _runs(key2)
    claim = torch.where(chosen, (h << 31) | qf, big)
    keep = chosen & (claim == torch.full_like(claim, big).scatter_reduce(
        0, grp2, claim, "amin")[grp2])
    return pair[keep], qf[keep], dbf[keep]


class VocabHEIndex:
    """Visual-word + Hamming-embedding image retrieval index."""

    def __init__(self, n_words: int = 4096, dim: int = 128,
                 bucket_cap: int | None = None,
                 hierarchical: bool | None = None, probes: int = 8,
                 device=None):
        """hierarchical: two-level vocabulary (the FLANN-tree
        replacement, visual_index.h:624-665); None = on for n_words >=
        16384. probes: coarse cells searched per descriptor at
        assignment; probes=0 selects exact blocked assignment over the
        flat vocabulary (kmeans_assign_blocked). The index's tensors live
        on `device`, the card unless the caller asks for the CPU."""
        self.n_words = n_words
        self.dim = dim
        self.bucket_cap = bucket_cap
        self.hierarchical = (n_words >= 16384 if hierarchical is None
                             else hierarchical)
        self.probes = probes
        self.device = resolve_device(device)
        self.words: torch.Tensor | None = None       # [W, D]
        self.coarse: torch.Tensor | None = None      # [K1, D] (hierarchical)
        self.fine: torch.Tensor | None = None        # [K1, K2, D]; sets _tree
        self.he_proj: torch.Tensor | None = None     # [D, 64]
        self.he_thresh: torch.Tensor | None = None   # [W, 64]
        self._entries: list = []        # staged (img, words, sigs, geom)
        self._names: list = []
        self._with_geometry = False     # some image was given its frames
        self._csr_feat = self._frames = None
        self._match_cap = 1 << 20       # records `vocab_match` makes room for
        self._prepared = False

    @staticmethod
    def _factor(n_words: int) -> tuple[int, int]:
        """Balanced k1*k2 = n_words factorization (k1 <= k2)."""
        k1 = int(n_words ** 0.5)
        while k1 > 1 and n_words % k1:
            k1 -= 1
        return k1, n_words // k1

    @property
    def n_images(self) -> int:
        return len(self._names)

    @property
    def fine(self) -> torch.Tensor | None:
        return self._fine

    @fine.setter
    def fine(self, value) -> None:
        """The fine words; on the card also their `integer_tree`, made
        once per tree here (so a plain assignment is seen too; replace
        `fine` rather than change it in place), which sends uint8 rows to
        the descent kernel. None for a float tree, and on the CPU, where
        the float path gives the same bits."""
        self._fine = value
        self._tree = None
        if value is not None and self.device.type == "cuda":
            self._tree = integer_tree(torch.as_tensor(
                value, dtype=torch.float32, device=self.device))

    def _as(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------------- train
    def train(self, gen: torch.Generator, descriptors, *,
              iters: int = 20) -> None:
        """Build the vocabulary + HE projection/thresholds from a training
        descriptor sample [N, D]. `gen` is a CPU torch.Generator."""
        x = self._as(descriptors)
        if self.hierarchical:
            k1, k2 = self._factor(self.n_words)
            hres = hierarchical_kmeans(gen, x, k1, k2, coarse_iters=iters,
                                       fine_iters=max(iters // 2, 6))
            self.coarse, self.fine = hres.coarse, hres.fine
            self.words = hres.flat_words()
            if self.probes == 0:
                assignments, _ = kmeans_assign_blocked(x, self.words)
            else:
                assignments, _ = hierarchical_assign(
                    x, self.coarse, self.fine, probes=self.probes)
        else:
            res = kmeans(gen, x, self.n_words, iters=iters, chunk=65536)
            self.words = res.centroids
            assignments = res.assignments
        # random orthogonal projection to 64 dims (QR of a Gaussian,
        # inverted_index.h:174-183); for dim < 64 independent orthogonal
        # blocks are concatenated until 64 columns exist. Drawn and
        # factored on the CPU, so every device gets the same projection.
        blocks = []
        for _ in range(-(-HE_BITS // self.dim)):
            g = torch.randn((self.dim, self.dim), generator=gen)
            blocks.append(torch.linalg.qr(g).Q)
        self.he_proj = torch.cat(blocks, 1)[:, :HE_BITS].to(self.device)
        proj = (x @ self.he_proj).cpu().numpy()                 # [N, 64]
        # per-word median threshold (inverted_file.h:276-292): one lexsort
        # per projection column keyed by (word, value) makes every word's
        # values contiguous and sorted, so the middle two index directly
        asg = assignments.cpu().numpy()
        counts = np.bincount(asg, minlength=self.n_words)
        starts = np.zeros(self.n_words + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        lo = starts[:-1]
        i1 = lo + np.maximum(counts - 1, 0) // 2
        i2 = lo + np.maximum(counts, 1) // 2
        last = max(len(proj) - 1, 0)
        i1 = np.minimum(i1, last)
        i2 = np.minimum(i2, last)
        thr = np.empty((self.n_words, HE_BITS), np.float32)
        for c in range(HE_BITS):
            order_c = np.lexsort((proj[:, c], asg))
            col = proj[order_c, c]
            thr[:, c] = 0.5 * (col[i1] + col[i2])
        global_med = (np.median(proj, axis=0) if len(proj)
                      else np.zeros(HE_BITS, np.float32))
        thr[counts == 0] = global_med
        self.he_thresh = torch.from_numpy(thr).to(self.device)

    # ------------------------------------------------------------------ add
    def _stage(self, descriptors):
        """Descriptors (numpy or a tensor) -> (x float32, rows) on the
        index's device. uint8 crosses to the card as it is (a quarter of
        float32's bytes), is converted there once, and is kept as `rows`
        for the tree descent's kernel; rows is None for anything else."""
        t = torch.as_tensor(descriptors)
        if t.dtype == torch.uint8:
            rows = t.to(self.device)
            return rows.to(torch.float32), rows
        return t.to(self.device, torch.float32), None

    def _assign(self, x: torch.Tensor, rows=None) -> torch.Tensor:
        """Word ids [K] int32 of descriptors x [K, D] float32 (rows: the
        same as uint8, or None)."""
        if self.hierarchical and self.probes == 0:
            words, _ = kmeans_assign_blocked(x, self.words)
        elif self.hierarchical:
            words, _ = hierarchical_assign(x, self.coarse, self.fine,
                                           probes=self.probes,
                                           tree=self._tree, rows=rows)
        else:
            words, _ = kmeans_assign(x, self.words)
        return words

    def _sign(self, x: torch.Tensor, words: torch.Tensor) -> torch.Tensor:
        """64-bit signatures [K] int64: the projection's bits above the
        word's thresholds (inverted_index.h:174-183)."""
        return _pack_bits(x @ self.he_proj > self.he_thresh[words.long()])

    def _encode(self, descriptors):
        """[K, D] -> (words [K] int32, signatures [K] int64)."""
        x, rows = self._stage(descriptors)
        words = self._assign(x, rows)
        return words, self._sign(x, words)

    def add_image(self, descriptors, name: str | None = None,
                  geometries=None) -> int:
        """Stage one image's descriptors [K, D] (call prepare() after).

        geometries: optional [K, 4] (x, y, scale, orientation) keypoint
        frames enabling query-time spatial verification
        (inverted_file_entry.h:47-109 stores the same 16-byte geometry).
        """
        (img_id,) = self.add_images(descriptors, [len(descriptors)],
                                    [name] if name else None, geometries)
        return img_id

    def add_images(self, descriptors, counts, names=None,
                   geometries=None) -> list[int]:
        """Stage many images at once (call prepare() after): descriptors
        [sum(counts), D], uint8 or float, the images' rows one after
        another, numpy or a tensor (on the card: encoded where it lies);
        counts [n] rows per image; names [n] (default img_<id>);
        geometries, optional, [sum(counts), 4] the rows' (x, y, scale,
        orientation) frames, which spatial verification reads (zeros
        where none are given). One encode pass, `_ADD_ROWS` rows a step.
        Returns the images' ids."""
        if self._names and not self._entries:
            # a load()ed index keeps only its baked bucket layout; new
            # stagings would orphan every loaded entry on re-prepare
            raise ValueError(
                "cannot add_image to a loaded VocabHEIndex: its entries "
                "are baked into the prepared layout; rebuild the index "
                "from descriptors to extend it")
        counts = np.asarray(counts, np.int64).reshape(-1)
        total = int(counts.sum())
        if len(descriptors) != total:
            raise ValueError(f"add_images: {len(descriptors)} rows for "
                             f"counts summing to {total}")
        words = np.empty(total, np.int32)
        sigs = np.empty(total, np.int64)
        for lo in range(0, total, _ADD_ROWS):
            x, rows = self._stage(descriptors[lo:lo + _ADD_ROWS])
            w = self._assign(x, rows)
            words[lo:lo + len(x)] = w.cpu().numpy()
            sigs[lo:lo + len(x)] = self._sign(x, w).cpu().numpy()
        if geometries is None:
            geom = np.zeros((total, 4), np.float32)
        else:
            geom = torch.as_tensor(geometries, dtype=torch.float32).reshape(
                total, 4).cpu().numpy()
            self._with_geometry = True
        ids = []
        ends = np.cumsum(counts)
        for j, (a, b) in enumerate(zip(ends - counts, ends)):
            img_id = self.n_images
            self._entries.append((img_id, words[a:b], sigs[a:b], geom[a:b]))
            self._names.append(names[j] if names is not None
                               else f"img_{img_id}")
            ids.append(img_id)
        self._prepared = False
        return ids

    # -------------------------------------------------------------- prepare
    def prepare(self) -> None:
        """Lay out padded per-word buckets (+ exact overflow tail), idf,
        burstiness weights, and per-image self-similarity norms
        (visual_index.h:505-508). The layout is host numpy; the
        self-similarity pass runs on the index's device."""
        if self._prepared and not self._entries:
            return                  # loaded index: layout already baked
        w_all = np.concatenate([w for _, w, _, _ in self._entries])
        s_all = np.concatenate([s for _, _, s, _ in self._entries])
        i_all = np.concatenate([np.full(len(w), i, np.int32)
                                for i, w, _, _ in self._entries])
        counts = np.bincount(w_all, minlength=self.n_words)
        cap = self.bucket_cap
        if cap is None:
            cap = int(min(max(counts.max(), 1),
                          max(8, 8 * max(1, len(w_all) // self.n_words))))
            # grow cap until the overflow tail holds <= 1/8 of all entries
            while cap < counts.max():
                tail_sz = int(np.clip(counts - cap, 0, None).sum())
                if tail_sz <= max(1024, len(w_all) // 8):
                    break
                cap *= 2
        cap = -(-cap // 8) * 8

        # entries sorted by (word, image), each group of one word in one
        # image contiguous (a stable sort on the index's device, the order
        # of np.lexsort((i_all, w_all)))
        key = torch.from_numpy(w_all.astype(np.int64) * max(self.n_images, 1)
                               + i_all).to(self.device)
        order = torch.argsort(key, stable=True).cpu().numpy()
        ws, is_, ss = w_all[order], i_all[order], s_all[order]
        grp = np.concatenate([[True], (ws[1:] != ws[:-1])
                              | (is_[1:] != is_[:-1])])
        gid = np.cumsum(grp) - 1
        gsize = np.bincount(gid)
        gstart = np.flatnonzero(grp)

        # smoothed idf log((N+1)/(n_w+0.5)), as `cvt_tpu`'s: n_w counts
        # the (word, image) groups of word w
        n_img_with_word = np.bincount(ws[gstart], minlength=self.n_words)
        idf = np.log((self.n_images + 1.0) / (n_img_with_word + 0.5))
        idf = np.maximum(idf, 0.0).astype(np.float32)

        # burstiness: weight 1/sqrt(#entries of this image in this word)
        burst = (1.0 / np.sqrt(gsize[gid])).astype(np.float32)

        starts = np.zeros(self.n_words + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        rank = np.arange(len(ws)) - starts[ws]
        keep = rank < cap
        over = ~keep

        b_img = np.full((self.n_words, cap), -1, np.int32)
        b_sig = np.zeros((self.n_words, cap), np.int64)
        b_burst = np.zeros((self.n_words, cap), np.float32)
        b_img[ws[keep], rank[keep]] = is_[keep]
        b_sig[ws[keep], rank[keep]] = ss[keep]
        b_burst[ws[keep], rank[keep]] = burst[keep]

        # exact overflow tail (padded to a multiple of 8, min 1 slot)
        t_n = int(over.sum())
        t_cap = max(8, -(-t_n // 8) * 8) if t_n else 1
        t_word = np.full((t_cap,), -1, np.int32)
        t_img = np.full((t_cap,), -1, np.int32)
        t_sig = np.zeros((t_cap,), np.int64)
        t_burst = np.zeros((t_cap,), np.float32)
        if t_n:
            t_word[:t_n] = ws[over]
            t_img[:t_n] = is_[over]
            t_sig[:t_n] = ss[over]
            t_burst[:t_n] = burst[over]

        # padded per-image entry tables for verification + self-similarity
        kmax = max(len(w) for _, w, _, _ in self._entries)
        kmax = -(-kmax // 8) * 8
        n = self.n_images
        e_words = np.full((n, kmax), -1, np.int32)
        e_sigs = np.zeros((n, kmax), np.int64)
        e_geom = np.zeros((n, kmax, 4), np.float32)
        e_valid = np.zeros((n, kmax), bool)
        for img_id, w, s, g in self._entries:
            k = len(w)
            e_words[img_id, :k] = w
            e_sigs[img_id, :k] = s
            e_geom[img_id, :k] = g
            e_valid[img_id, :k] = True
        self._set_layout(b_img=b_img, b_sig=b_sig, b_burst=b_burst,
                         t_word=t_word, t_img=t_img, t_sig=t_sig,
                         t_burst=t_burst, e_words=e_words, e_sigs=e_sigs,
                         e_geom=e_geom, e_valid=e_valid, idf=idf)
        # the entries sorted by (word, image) are the lists in CSR form:
        # each word's bucket entries, then its tail entries, in this order;
        # with frames, also each entry's row in the flat feature order
        # (`order`) and that order's frame table, for the ragged
        # verification
        feat = frames = None
        if self._with_geometry:
            feat = torch.from_numpy(order.astype(np.int32))
            frames = torch.from_numpy(np.concatenate(
                [g for _, _, _, g in self._entries]))
        self._set_lists(*(torch.from_numpy(a) for a in (starts, is_, ss,
                                                        burst)),
                        feat=feat, frames=frames)

        # self-similarity from each image's own entries
        # (inverted_index.h:238-288): the pairs of each (word, image) group
        dev = self.device
        selfs = _self_similarity_groups(
            torch.from_numpy(is_).to(dev),
            torch.from_numpy(ss).to(dev), torch.from_numpy(gstart).to(dev),
            torch.from_numpy(gsize).to(dev),
            torch.from_numpy(ws[gstart].astype(np.int64)).to(dev),
            self._idf, n)
        self._self_norm = torch.sqrt(torch.clamp_min(selfs, 1e-12))
        self._prepared = True

    def _set_layout(self, **arrays) -> None:
        """The prepared layout's host arrays -> the index's tensors
        (`_b_img`, ..., `_idf`); signatures as int64. The bucket and tail
        arrays (`_HOST_LAYOUT`) stay CPU tensors over the host arrays;
        the rest go to the index's device."""
        for name, a in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            setattr(self, "_" + name,
                    t if name in _HOST_LAYOUT else t.to(self.device))
        self.n_overflow = int(np.sum(arrays["t_img"] >= 0))

    def _lists_from_buckets(self) -> tuple:
        """The inverted file in CSR form from the host bucket layout: each
        word's bucket entries in bucket order, then its tail entries in
        tail order (`_set_lists`' arguments, on the host)."""
        keep = self._b_img >= 0
        t_keep = (self._t_img >= 0) & (self._t_word >= 0)
        w = torch.cat([torch.nonzero(keep)[:, 0], self._t_word[t_keep].long()])
        order = torch.argsort(w, stable=True)
        off = torch.zeros(self.n_words + 1, dtype=torch.int64)
        torch.cumsum(torch.bincount(w, minlength=self.n_words), 0,
                     out=off[1:])
        return (off, *(torch.cat([b[keep], t[t_keep]])[order]
                       for b, t in ((self._b_img, self._t_img),
                                    (self._b_sig, self._t_sig),
                                    (self._b_burst, self._t_burst))))

    def _set_lists(self, off, img, sig, burst, feat=None,
                   frames=None) -> None:
        """The inverted file that the scoring pass reads (cvt's per-word
        lists, inverted_file.h), to the index's device: word offsets
        `_csr_off` [W+1] int64 and, per entry sorted by word, its image
        `_csr_img` int32, signature `_csr_sig` int64 and burstiness
        `_csr_burst` float32; and the Hamming weights `_wtab` [25],
        exp(-h^2/sigma^2) for h = 0..24. With frames, as cvt's entries
        carry `feature_idx` and a geometry (inverted_file_entry.h:47-109):
        each entry's database feature `_csr_feat` int32, its row in the
        flat frame table `_frames` [N, 4] float32; else both None."""
        self._csr_off, self._csr_img, self._csr_sig, self._csr_burst = (
            t.contiguous().to(self.device) for t in (off, img, sig, burst))
        self._csr_feat, self._frames = (
            None if t is None else t.contiguous().to(self.device)
            for t in (feat, frames))
        self._wtab = _he_weight(torch.arange(HE_MAX_DIST + 1,
                                             device=self.device))

    # --------------------------------------------------------------- query
    def _layout(self) -> tuple:
        """The bucket scoring pass's arrays (`_score_query_many`, which
        only the tests run): buckets, tail and idf, on the index's
        device (the buckets and the tail copied there for the call)."""
        return tuple(t.to(self.device) for t in (
            self._b_img, self._b_sig, self._b_burst, self._t_word,
            self._t_img, self._t_sig, self._t_burst, self._idf))

    def _csr(self) -> tuple:
        """The inverted file's arrays as `vocab_score` takes them."""
        return (self._csr_off, self._csr_img, self._csr_sig,
                self._csr_burst, self._idf, self._wtab)

    def _score_flat(self, f_word, f_sig, f_query, n_queries: int):
        """Flat query features (f_word int32, -1 for none; f_sig int64;
        f_query, the query of each) -> scores [n_queries, n_images]
        normalized by the image and query self-similarities. A query's
        self-similarity is the float64 sum of its words' idf^2, rounded to
        float32 once."""
        with span("vocab.score"):
            raw = vocab_score(f_word.to(torch.int32).contiguous(),
                              f_sig.contiguous(),
                              f_query.to(torch.int32).contiguous(),
                              *self._csr(), n_queries, self.n_images)
        with span("vocab.normalize"):
            w = f_word.long()
            idf2 = torch.where(w >= 0, self._idf[w.clamp_min(0)] ** 2, 0.0)
            q_self = torch.zeros(n_queries, dtype=torch.float64,
                                 device=raw.device).index_add_(
                0, f_query.long(), idf2.double()).float()
            q_self = torch.sqrt(torch.clamp_min(q_self, 1e-12))
            return raw / (self._self_norm[None, :] * q_self[:, None])

    def _verified(self, norm, words, sigs, valid, geom, verify: int,
                  image_extent: float, chunk: int):
        """norm [Q, n_images] with each query's top-`verify` candidates'
        spatial verification scores added, `chunk` queries at a time
        (visual_index.h:481-501)."""
        c = min(verify, self.n_images)
        _, cand = top_k_largest(norm, c)                       # [Q, C]
        parts = []
        for lo in range(0, norm.shape[0], chunk):
            ci = cand[lo:lo + chunk]
            parts.append(_verify_candidates(
                words[lo:lo + chunk], sigs[lo:lo + chunk],
                valid[lo:lo + chunk], geom[lo:lo + chunk],
                self._e_words[ci], self._e_sigs[ci], self._e_valid[ci],
                self._e_geom[ci], self._idf, image_extent))
        return norm.scatter_add(-1, cand, torch.cat(parts))

    def _verified_flat(self, norm, f_word, f_sig, f_query, geometries,
                       verify: int, image_extent: float):
        """`_verified` of a ragged batch: norm [Q, n_images] with each
        query's top-`verify` candidates' spatial verification scores
        added; the batch's query features flat (f_word int32, f_sig,
        f_query int32 as `vocab_score` takes them), geometries [F, 4]
        their frames. The candidates' matches come from the inverted file
        (`vocab_match`), the 1-to-1 rule and vote-and-verify run on the
        one flat list of them (visual_index.h:376-501)."""
        q, n = norm.shape
        c = min(verify, n)
        dev = norm.device
        with span("vocab.verify"):
            geom = self._as(geometries).reshape(-1, 4)
            _, cand = top_k_largest(norm, c)                   # [Q, C]
            with span("vocab.match"):
                table = torch.full((q, n), -1, dtype=torch.int32,
                                   device=dev)
                table.scatter_(1, cand, torch.arange(
                    q * c, dtype=torch.int32, device=dev).reshape(q, c))
                rec = vocab_match(f_word, f_sig, f_query, self._csr_off,
                                  self._csr_img, self._csr_sig,
                                  self._csr_feat, table, HE_MAX_DIST,
                                  self._match_cap)
                # room for a quarter more than the most a batch has made
                self._match_cap = max(self._match_cap,
                                      rec.shape[0] + rec.shape[0] // 4)
                pair, qf, dbf = _one_to_one(rec, f_word.shape[0],
                                            self._frames.shape[0])
            with span("vocab.vote"):
                eff = vote_and_verify_segmented(
                    geom[qf], self._frames[dbf], pair, q * c,
                    image_extent=image_extent).score
            return norm.scatter_add(-1, cand, eff.reshape(q, c))

    def query(self, descriptors, *, topk: int = 10, valid=None,
              geometries=None, verify: int = 0,
              image_extent: float = 1024.0):
        """descriptors [Kq, D] -> (names, normalized scores).

        verify > 0 re-ranks the top-`verify` candidates by spatial
        verification (visual_index.h Query with
        num_images_after_verification): requires `geometries` [Kq, 4]
        and geometry-carrying add_image calls. The vote-and-verify score
        is added to the tf-idf score before the final ranking."""
        if not self._prepared:
            self.prepare()
        words, sigs = self._encode(descriptors)
        kq = words.shape[0]
        valid = (torch.ones((kq,), dtype=torch.bool, device=self.device)
                 if valid is None
                 else torch.as_tensor(valid, device=self.device).bool())
        norm = self._score_flat(
            torch.where(valid, words, -1), sigs,
            torch.zeros(kq, dtype=torch.int32, device=self.device), 1)
        if verify > 0:
            if geometries is None:
                raise ValueError("verify>0 requires query `geometries`")
            norm = self._verified(norm, words[None], sigs[None], valid[None],
                                  self._as(geometries).reshape(1, kq, 4),
                                  verify, image_extent, 1)
        v, i = top_k_largest(norm[0], min(topk, self.n_images))
        return [self._names[j] for j in i.tolist()], v.cpu().numpy()

    def query_batch(self, descriptors, *, counts=None, topk: int = 10,
                    valid=None, geometries=None, verify: int = 0,
                    image_extent: float = 1024.0,
                    verify_chunk: int = 8):
        """Batched multi-image query -> (ids [Q, topk], scores [Q, topk],
        names), on the host.

        Two forms of the batch:
          * padded: descriptors [Q, Kq, D], valid [Q, Kq] (default all);
          * ragged: descriptors [sum(counts), D], the Q images' rows one
            after another, and counts [Q]. uint8 rows cross to the card
            as they are, are converted there and also go as they are to
            the tree descent (its kernel, on an integer tree); only real
            rows are encoded.
        One descriptor -> word assignment pass covers every query image
        and one pass of the inverted file (`vocab_score`) scores the whole
        batch. verify > 0 re-ranks each query's top-`verify` candidates
        spatially (requires `geometries`: [Q, Kq, 4] padded, [sum(counts),
        4] ragged). The padded form verifies `verify_chunk` queries at a
        time on the padded entry tables ([chunk, C, Kq, Ki] match
        tensors); the ragged form finds the candidates' matches in the
        inverted file and verifies them as one flat list, and needs an
        index built here with frames (`add_images(..., geometries=)`)."""
        if verify > 0 and geometries is None:
            raise ValueError("verify>0 requires query `geometries`")
        if not self._prepared:
            self.prepare()
        if verify > 0 and counts is not None and self._csr_feat is None:
            raise ValueError("verify>0 on the ragged form needs an index "
                             "built with frames: add_images(..., "
                             "geometries=)")
        with span("vocab.search"):
            with span("vocab.stage_in"):
                x, rows = self._stage(descriptors)
                if counts is not None:
                    cnt = torch.as_tensor(counts).to(self.device)
                    q = cnt.shape[0]
                    f_query = torch.repeat_interleave(
                        torch.arange(q, device=self.device), cnt,
                        output_size=x.shape[0])
                else:
                    q, kq, d = x.shape
                    x = x.reshape(q * kq, d)
                    rows = None if rows is None else rows.reshape(q * kq, d)
                    f_query = torch.arange(
                        q, device=self.device).repeat_interleave(kq)
                    valid = (torch.ones((q, kq), dtype=torch.bool,
                                        device=self.device) if valid is None
                             else torch.as_tensor(valid,
                                                  device=self.device).bool())
            with span("vocab.assign"):
                words = self._assign(x, rows)
            with span("vocab.sign"):
                sigs = self._sign(x, words)
            f_word = (words if counts is not None
                      else torch.where(valid.reshape(-1), words, -1))
            norm = self._score_flat(f_word, sigs, f_query, q)
            if verify > 0 and counts is not None:
                norm = self._verified_flat(
                    norm, f_word.to(torch.int32).contiguous(), sigs,
                    f_query.to(torch.int32).contiguous(), geometries,
                    verify, image_extent)
            elif verify > 0:
                norm = self._verified(norm, words.reshape(q, kq),
                                      sigs.reshape(q, kq), valid,
                                      self._as(geometries).reshape(q, kq, 4),
                                      verify, image_extent, verify_chunk)
            with span("vocab.select"):
                v, i = top_k_largest(norm, min(topk, self.n_images))
                return i.cpu().numpy(), v.cpu().numpy(), self._names

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        """Write `cvt_tpu`'s .npz layout (signatures as [..., 2] uint32)."""
        if not self._prepared:
            self.prepare()
        hier = self.hierarchical and self.coarse is not None

        def host(t):
            return t.cpu().numpy()
        np.savez(path, words=host(self.words),
                 coarse=(host(self.coarse) if hier
                         else np.zeros((0, self.dim), np.float32)),
                 fine=(host(self.fine) if hier
                       else np.zeros((0, 0, self.dim), np.float32)),
                 he_proj=host(self.he_proj),
                 he_thresh=host(self.he_thresh),
                 b_img=host(self._b_img),
                 b_sig=sigs_to_u32(host(self._b_sig)),
                 b_burst=host(self._b_burst),
                 t_word=host(self._t_word),
                 t_img=host(self._t_img),
                 t_sig=sigs_to_u32(host(self._t_sig)),
                 t_burst=host(self._t_burst),
                 e_words=host(self._e_words),
                 e_sigs=sigs_to_u32(host(self._e_sigs)),
                 e_geom=host(self._e_geom),
                 e_valid=host(self._e_valid),
                 idf=host(self._idf),
                 self_norm=host(self._self_norm),
                 names=np.array(self._names))

    @classmethod
    def _from_arrays(cls, z, device=None) -> "VocabHEIndex":
        """An index from the arrays `save` writes (a dict or an NpzFile):
        the vocabulary (words, coarse, fine, he_proj, he_thresh) and, when
        present, the prepared layout and names. With the vocabulary alone
        the index is trained and empty, ready for add_image."""
        hier = "coarse" in z and z["coarse"].shape[0] > 0
        idx = cls(n_words=z["words"].shape[0], dim=z["words"].shape[1],
                  hierarchical=hier, device=device)

        def dev(a):
            return torch.from_numpy(np.array(a, np.float32)).to(idx.device)
        idx.words = dev(z["words"])
        if hier:
            idx.coarse, idx.fine = dev(z["coarse"]), dev(z["fine"])
        idx.he_proj, idx.he_thresh = dev(z["he_proj"]), dev(z["he_thresh"])
        if "b_img" not in z:
            return idx
        idx._set_layout(
            b_img=z["b_img"], b_sig=sigs_from_u32(z["b_sig"]),
            b_burst=z["b_burst"], t_word=z["t_word"], t_img=z["t_img"],
            t_sig=sigs_from_u32(z["t_sig"]), t_burst=z["t_burst"],
            e_words=z["e_words"], e_sigs=sigs_from_u32(z["e_sigs"]),
            e_geom=z["e_geom"], e_valid=z["e_valid"], idf=z["idf"],
            self_norm=z["self_norm"])
        idx._set_lists(*idx._lists_from_buckets())
        idx._names = [str(s) for s in z["names"]]
        idx._prepared = True
        return idx

    @classmethod
    def load(cls, path: str, device=None) -> "VocabHEIndex":
        with np.load(path, allow_pickle=False) as z:
            return cls._from_arrays(z, device)
