"""The plain reference of the vocabulary tree with 64-bit Hamming
embedding: float64 PyTorch, nothing of the port.

It encodes the whole database itself from the run's inputs (the uint8
descriptors, the tree, the HE projection and thresholds) and scores query
images of the database against it, following the cvt lines that the
port's `index/vocab_he.py` cites (vlindex `VisualIndex<uint8_t,128,64>`):

  * the word of a descriptor: the `probes` nearest coarse cells
    (ascending distance, the lower cell first among equal distances), the
    nearest word of each cell (the first among equal distances), and of
    those the nearest, an earlier probe keeping a tie (visual_index.h:
    624-665 and 700-739 descend FLANN's tree; this is the port's two-level
    form of it, exe/vocab_tree.cc:74-78);
  * the signature: bit b set where the projection's column b exceeds the
    word's threshold b (inverted_index.h:174-183, inverted_file.h:276-292);
  * idf: log((N + 1) / (n_w + 0.5)), at least 0, n_w the images holding
    word w. This is the smoothed form that the port documents (from
    cvt_tpu), not re-derived from inverted_file.h:258-266, which this repo
    does not hold: a departure from cvt only if cvt's form differs;
  * burstiness: an entry of word w in image i weighs 1/sqrt(#entries of
    image i in word w) (inverted_file.h:295-353);
  * a query feature (word w, signature s) and an entry e of w's list
    within 24 bits score exp(-h^2/16^2) * idf_w^2 * burst_e for e's image
    (inverted_file.h:295-353, utils.h:52-83); the query side takes no
    burstiness weight, as the port's scoring does (a departure from
    vlindex's /sqrt(votes) on the query's own repeats, if it has one);
  * an image's self-similarity: the same sum over the pairs of entries of
    one word within the image (inverted_index.h:238-288); a query's: the
    sum of its features' idf^2, as the port takes it; the score is the sum
    over both square roots.

Everything is float64 but the inputs, which are float32 or uint8.
`control()` gives the same reference computed in bfloat16, the precision
below the configuration's: its descent, projection and term weights;
`signing_control()` keeps the float64 descent and computes the projection
and the term weights alone in bfloat16.
"""

from __future__ import annotations

import copy

import torch

F64 = torch.float64
_BYTE = torch.tensor([bin(i).count("1") for i in range(256)],
                     dtype=torch.int64)
_TILE = 512                     # pairs of one cell per GEMM tile
_STEP = 1 << 28                 # bytes of one step's [tiles, rows, K2]
_PAIRS = 1 << 23                # pairs of query features and entries a step


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64, by bytes."""
    table = _BYTE.to(x.device)
    out = table[x & 255]
    for s in range(8, 64, 8):
        out = out + table[(x >> s) & 255]
    return out


def he_weight(h: torch.Tensor, max_dist: int, sigma: float) -> torch.Tensor:
    w = torch.exp(-(h.to(F64) ** 2) / (sigma * sigma))
    return torch.where(h <= max_dist, w, 0.0)


def _cell_argmin(x, cells, fine, f_sq):
    """For every (row, probe) pair [T, P], the squared distance to the
    nearest word of its cell and that word's index in the cell (the
    first among equal distances): the pairs sorted by cell, in tiles of
    one cell, each step one batched GEMM in x's dtype."""
    t, p = cells.shape
    k1, k2, d = fine.shape
    dev = x.device
    n = t * p
    flat = cells.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=k1)
    per = (counts + _TILE - 1) // _TILE
    tile_cell = torch.repeat_interleave(torch.arange(k1, device=dev), per)
    first = torch.cumsum(counts, 0) - counts
    tile0 = torch.cumsum(per, 0) - per
    j = torch.arange(tile_cell.shape[0], device=dev) - tile0[tile_cell]
    pos = (first[tile_cell] + j * _TILE)[:, None] + torch.arange(
        _TILE, device=dev)[None, :]
    valid = pos < (first + counts)[tile_cell][:, None]
    pair = torch.where(valid, order[pos.clamp_max(n - 1)], n)
    xs = torch.cat([x, torch.zeros((1, d), dtype=x.dtype, device=dev)])
    x_sq = torch.sum(xs * xs, 1)
    dist = torch.empty(n + 1, dtype=x.dtype, device=dev)
    sub = torch.empty(n + 1, dtype=torch.int64, device=dev)
    step = max(1, _STEP // (_TILE * k2 * 8))
    for lo in range(0, tile_cell.shape[0], step):
        pr = pair[lo:lo + step]
        row = torch.div(pr, p, rounding_mode="floor").clamp_max(t)
        c = tile_cell[lo:lo + step]
        dd = (x_sq[row][..., None] - 2.0 * torch.bmm(xs[row], fine[c].mT)
              + f_sq[c][:, None, :])
        v, a = torch.min(dd, -1)
        dist[pr.reshape(-1)] = v.reshape(-1)
        sub[pr.reshape(-1)] = a.reshape(-1)
    return dist[:n].reshape(t, p), sub[:n].reshape(t, p)


def assign(x_u8: torch.Tensor, coarse: torch.Tensor, fine: torch.Tensor,
           probes: int, dtype=F64, chunk: int = 131_072) -> torch.Tensor:
    """Word ids [N] int64 (cell * K2 + sub) of uint8 or float rows, in
    `dtype`, `chunk` rows a step."""
    k1, k2, d = fine.shape
    c = coarse.to(dtype)
    f = fine.to(dtype)
    c_sq = torch.sum(c * c, 1)
    f_sq = torch.sum(f * f, 2)
    out = torch.empty(x_u8.shape[0], dtype=torch.int64, device=x_u8.device)
    for lo in range(0, x_u8.shape[0], chunk):
        x = x_u8[lo:lo + chunk].to(dtype)
        x_sq = torch.sum(x * x, 1, keepdim=True)
        d1 = x_sq - 2.0 * (x @ c.T) + c_sq[None, :]
        cells = torch.sort(d1, dim=1, stable=True).indices[:, :probes]
        dist, sub = _cell_argmin(x, cells, f, f_sq)
        best_d = dist[:, 0].clone()
        best_w = cells[:, 0] * k2 + sub[:, 0]
        for q in range(1, probes):
            upd = dist[:, q] < best_d
            best_d = torch.where(upd, dist[:, q], best_d)
            best_w = torch.where(upd, cells[:, q] * k2 + sub[:, q], best_w)
        out[lo:lo + chunk] = best_w
    return out


def signatures(x_u8, words, proj, thresh, dtype=F64,
               chunk: int = 1 << 20) -> torch.Tensor:
    """int64 signatures: bit b where (x @ proj)[:, b] > thresh[word, b],
    computed in `dtype`."""
    bits = (1 << torch.arange(64, device=x_u8.device, dtype=torch.int64))
    bits[63] = -(1 << 63)
    out = torch.empty(x_u8.shape[0], dtype=torch.int64, device=x_u8.device)
    p = proj.to(dtype)
    for lo in range(0, x_u8.shape[0], chunk):
        x = x_u8[lo:lo + chunk].to(dtype)
        above = (x @ p) > thresh[words[lo:lo + chunk]].to(dtype)
        out[lo:lo + chunk] = torch.sum(torch.where(above, bits, 0), 1)
    return out


class VocabRef:
    """The database encoded in float64, its inverted file, idf,
    burstiness and self-similarities; `scores` and `best` of query images
    of the database."""

    def __init__(self, descriptors: torch.Tensor, counts, coarse, fine,
                 proj, thresh, probes: int, max_dist: int, sigma: float,
                 precision=F64):
        dev = descriptors.device
        self.max_dist, self.sigma, self.weights = max_dist, sigma, precision
        self.n_images = len(counts)
        self._counts = counts
        self.n_words = fine.shape[0] * fine.shape[1]
        cnt = torch.as_tensor(counts, dtype=torch.int64, device=dev)
        self.img_off = torch.cat([torch.zeros(1, dtype=torch.int64,
                                              device=dev),
                                  torch.cumsum(cnt, 0)])
        self.img = torch.repeat_interleave(
            torch.arange(self.n_images, device=dev), cnt)
        self.words = assign(descriptors, coarse, fine, probes, precision)
        self._x, self._proj, self._thresh = descriptors, proj, thresh
        self._tree = (coarse, fine, probes)
        self._index(precision)

    def _index(self, precision) -> None:
        """Signatures in `precision`, then the lists sorted by (word,
        image), idf, burstiness and self-similarities."""
        dev = self.words.device
        self.sigs = signatures(self._x, self.words, self._proj, self._thresh,
                               precision)
        key = self.words * self.n_images + self.img
        order = torch.argsort(key, stable=True)
        ks = key[order]
        new = torch.ones_like(ks, dtype=torch.bool)
        new[1:] = ks[1:] != ks[:-1]
        gid = torch.cumsum(new.long(), 0) - 1
        gsize = torch.bincount(gid)
        ws = self.words[order]
        self.lengths = torch.bincount(ws, minlength=self.n_words)
        self.off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                              torch.cumsum(self.lengths, 0)])
        self.e_img = self.img[order]
        self.e_sig = self.sigs[order]
        self.e_burst = 1.0 / torch.sqrt(gsize[gid].to(F64))
        n_w = torch.bincount(ws[new], minlength=self.n_words).to(F64)
        self.idf = torch.clamp_min(
            torch.log((self.n_images + 1.0) / (n_w + 0.5)), 0.0)
        gstart = torch.nonzero(new)[:, 0]
        self.self_norm = torch.sqrt(torch.clamp_min(self._self_sums(
            gstart, gsize, ws[gstart]), 1e-300))

    def _term(self, h, idf, burst):
        t = he_weight(h, self.max_dist, self.sigma) * idf ** 2 * burst
        return t if self.weights == F64 else t.to(self.weights).to(F64)

    def _self_sums(self, gstart, gsize, gword):
        dev = gstart.device
        n_pairs = gsize * gsize
        cum = torch.cumsum(n_pairs, 0)
        out = torch.zeros(self.n_images, dtype=F64, device=dev)
        lo, ends = 0, cum.cpu()
        while lo < len(ends):
            base = int(ends[lo - 1]) if lo else 0
            hi = max(lo + 1, int(torch.searchsorted(ends, base + _PAIRS,
                                                    right=True)))
            n = int(ends[hi - 1]) - base
            gi = torch.repeat_interleave(torch.arange(lo, hi, device=dev),
                                         n_pairs[lo:hi], output_size=n)
            r = torch.arange(base, base + n, device=dev) - (cum[gi]
                                                            - n_pairs[gi])
            g = gsize[gi]
            i, j = gstart[gi] + r // g, gstart[gi] + r % g
            h = popcount(self.e_sig[i] ^ self.e_sig[j])
            term = self._term(h, self.idf[gword[gi]],
                              1.0 / torch.sqrt(g.to(F64)))
            out.index_add_(0, self.e_img[gstart[gi]], term)
            lo = hi
        return out

    def features(self, images: torch.Tensor):
        """The query features of database images: (word, signature, the
        position of its image in `images`)."""
        dev = self.words.device
        a, b = self.img_off[images], self.img_off[images + 1]
        n = b - a
        q = torch.repeat_interleave(torch.arange(len(images), device=dev), n)
        r = torch.arange(int(n.sum()), device=dev) - (torch.cumsum(n, 0)
                                                      - n)[q]
        rows = a[q] + r
        return self.words[rows], self.sigs[rows], q

    def scores(self, images) -> torch.Tensor:
        """Normalized scores [S, n_images] float64 of database images
        (ids [S]) as queries."""
        dev = self.words.device
        images = torch.as_tensor(images, dtype=torch.int64, device=dev)
        fw, fs, fq = self.features(images)
        s = len(images)
        out = torch.zeros(s * self.n_images, dtype=F64, device=dev)
        length = self.lengths[fw]
        cum = torch.cumsum(length, 0)
        lo, ends = 0, cum.cpu()
        while lo < len(ends):
            base = int(ends[lo - 1]) if lo else 0
            hi = max(lo + 1, int(torch.searchsorted(ends, base + _PAIRS,
                                                    right=True)))
            n = int(ends[hi - 1]) - base
            fi = torch.repeat_interleave(torch.arange(lo, hi, device=dev),
                                         length[lo:hi], output_size=n)
            e = self.off[fw[fi]] + (torch.arange(base, base + n, device=dev)
                                    - (cum[fi] - length[fi]))
            h = popcount(fs[fi] ^ self.e_sig[e])
            term = self._term(h, self.idf[fw[fi]], self.e_burst[e])
            out.index_add_(0, fq[fi] * self.n_images + self.e_img[e], term)
            lo = hi
        q_self = torch.zeros(s, dtype=F64, device=dev).index_add_(
            0, fq, self.idf[fw] ** 2)
        out = out.reshape(s, self.n_images)
        return out / (self.self_norm[None, :]
                      * torch.sqrt(torch.clamp_min(q_self, 1e-300))[:, None])

    def best(self, scores: torch.Tensor, k: int):
        """The k best (scores descending, the lower id first among equal
        scores) of each row."""
        order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
        return torch.gather(scores, 1, order), order

    def pairs(self, images) -> int:
        """Pairs of a query feature and an entry of its word's list that
        scoring these database images as queries walks."""
        images = torch.as_tensor(images, dtype=torch.int64,
                                 device=self.words.device)
        fw, _, _ = self.features(images)
        return int(self.lengths[fw].sum())

    def distinct_entries(self, images) -> int:
        """Entries of the lists of the distinct words of these images."""
        images = torch.as_tensor(images, dtype=torch.int64,
                                 device=self.words.device)
        fw, _, _ = self.features(images)
        return int(self.lengths[torch.unique(fw)].sum())

    def control(self) -> "VocabRef":
        """The same reference computed in bfloat16: its descent, its
        projection and its term weights (sums in float64)."""
        coarse, fine, probes = self._tree
        return VocabRef(self._x, self._counts, coarse, fine, self._proj,
                        self._thresh, probes, self.max_dist, self.sigma,
                        torch.bfloat16)

    def signing_control(self) -> "VocabRef":
        """The same reference with its words, but its projection and its
        term weights in bfloat16 (sums in float64)."""
        c = copy.copy(self)
        c.weights = torch.bfloat16
        c._index(torch.bfloat16)
        return c
