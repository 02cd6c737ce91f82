"""The plain reference of spatially verified retrieval on the vocabulary
tree: float64 PyTorch, nothing of the port, over `reference/vocab.py`'s
VocabRef (the words, signatures and normalised scores).

A query image of the database is verified against candidate images of
it as vlindex's `VisualIndex::Query` does with
`num_images_after_verification` (visual_index.h:376-501), in the form
that cvt_tpu's `vote_and_verify` (the port's `match/vote_verify.py`) and
`_verify_candidates` (`index/vocab_he.py`) give it; vote_and_verify.cc
itself is not in this repository, so its steps and lines are those the
port's docstrings cite:

  * matches: a query feature and a feature of the candidate image with
    the same word and signatures at most `max_dist` bits apart
    (visual_index.h:376-430);
  * 1-to-1: each query feature keeps its best candidate feature (lowest
    Hamming distance, then the first), each candidate feature its best
    claimant (lowest distance, then the first query feature). The
    padded form's weight exp(-h^2/sigma^2) idf^2 is the same order within
    one word, so the rule is taken on distances here;
  * votes: each match's similarity (log2 scale ratio, the angle wrapped
    to [-pi, pi], the translation that carries frame 1 onto frame 2),
    quantized into 16 x 16 x 8 x 8 bins over [-extent, extent]^2, 8
    octaves and a turn, truncated toward zero and clipped
    (vote_and_verify.cc:238-288);
  * the pyramid: a bin's score is its votes plus 0.5^l times its level-l
    parent's, l = 1..5, a parent being the bin's coordinates shifted
    right by l with the finest strides (:270-283, :294-318); only
    occupied bins compete;
  * the 8 best bins (score, then the lower bin) each fit an affine by
    least squares over their matches, regularised by 1e-6 I; a model
    counts its matches whose transfer error is under 8 px and whose scale
    ratio (frame area through the model against the other's) is within
    2^2 either way (ComputeInliers :173-189, ComputeScaleError :104-115);
    its support is 0 unless it is finite and its bin held 3 matches; the
    first most supported wins, and one refit over its inliers replaces
    it where that is finite, holds 3 inliers and counts at least as many
    (the LO step, :379-397);
  * the score: the effective inlier count, the occupied cells of a 64 x
    64 grid over the winning inliers' bounding box in the query image
    (ComputeEffectiveInlierCount :152-204), added to the image's
    normalised score (visual_index.h:481-484).

Departures, all the port's as well: the query's own features take no
burstiness weight in matching (as in VocabRef); the affine is fitted
from each seed bin's matches where vlindex's estimator may differ. The
arithmetic is float64 throughout; `control()` gives the same reference
with the frames, the votes and the affine fits rounded to bfloat16 at
each step. It is computed a query image at a time on the run's device.
"""

from __future__ import annotations

import torch

from benchmark.reference.vocab import F64, popcount

BINS = (16, 16, 8, 8)         # tx, ty, log2 scale, angle
LEVELS = 6
SEEDS = 8
THRESHOLD = 8.0
MAX_SCALE_ERROR = 2.0
EFF_BINS = 64


def _bin(v: torch.Tensor, n: int) -> torch.Tensor:
    """Truncated toward zero, clipped to 0..n-1 (NaN to 0)."""
    v = torch.nan_to_num(v, nan=0.0).clamp(-1.0, float(n))
    return v.trunc().long().clamp(0, n - 1)


def one_to_one(slot, qf, df, h):
    """Indices of the kept matches: each (slot, query feature) its least
    (h, database feature), then each (slot, database feature) its least
    (h, query feature), by stable sorts."""
    def lex(*keys):
        order = torch.arange(keys[0].shape[0], device=keys[0].device)
        for k in reversed(keys):
            order = order[torch.argsort(k[order], stable=True)]
        return order

    def firsts(order, *keys):
        new = torch.zeros(order.shape[0], dtype=torch.bool,
                          device=order.device)
        new[:1] = True
        for k in keys:
            s = k[order]
            new[1:] |= s[1:] != s[:-1]
        return order[new]

    o = lex(slot, qf, h, df)
    a = firsts(o, slot, qf)
    o2 = a[lex(slot[a], df[a], h[a], qf[a])]
    return firsts(o2, slot, df)


class VerifiedRef:
    """VocabRef's normalised scores with each query's `verify` best
    images re-scored by vote-and-verify."""

    def __init__(self, base, frames: torch.Tensor, verify: int,
                 image_extent: float, precision=F64):
        self.base, self.verify, self.extent = base, verify, image_extent
        self.precision = precision
        self.frames = self._r(frames.to(F64))

    def _r(self, t: torch.Tensor) -> torch.Tensor:
        """t rounded to the reference's precision (kept as float64)."""
        return t if self.precision == F64 else t.to(self.precision).to(F64)

    @property
    def n_images(self) -> int:
        return self.base.n_images

    def distinct_entries(self, images) -> int:
        """VocabRef's: the entries of the lists of these images' words."""
        return self.base.distinct_entries(images)

    def control(self) -> "VerifiedRef":
        """The same reference with frames, votes and affine fits in
        bfloat16."""
        return VerifiedRef(self.base, self.frames, self.verify, self.extent,
                           torch.bfloat16)

    def signing_control(self) -> "VerifiedRef":
        """The same reference over `VocabRef.signing_control`: the
        normalised scores with the projection and the term weights in
        bfloat16, the verification in float64."""
        return VerifiedRef(self.base.signing_control(), self.frames,
                           self.verify, self.extent)

    # ------------------------------------------------------------ matches
    def _rows(self, image: int):
        a, b = self.base.img_off[image], self.base.img_off[image + 1]
        return torch.arange(int(a), int(b), device=self.frames.device)

    def matches(self, image: int, cands: torch.Tensor):
        """(slot, query row, database row, h) of every match of the query
        image's features with the candidates' (slot: the candidate's
        place in `cands`)."""
        dev = self.frames.device
        words, sigs = self.base.words, self.base.sigs
        q = self._rows(image)
        a = self.base.img_off[cands]
        n = self.base.img_off[cands + 1] - a
        slot = torch.repeat_interleave(torch.arange(len(cands), device=dev),
                                       n)
        rows = a[slot] + (torch.arange(int(n.sum()), device=dev)
                          - (torch.cumsum(n, 0) - n)[slot])
        order = torch.argsort(words[rows], stable=True)
        cw = words[rows][order]
        lo = torch.searchsorted(cw, words[q])
        cnt = torch.searchsorted(cw, words[q], right=True) - lo
        fi = torch.repeat_interleave(torch.arange(len(q), device=dev), cnt)
        j = order[lo[fi] + (torch.arange(int(cnt.sum()), device=dev)
                            - (torch.cumsum(cnt, 0) - cnt)[fi])]
        h = popcount(sigs[q[fi]] ^ sigs[rows[j]])
        keep = h <= self.base.max_dist
        return slot[j][keep], q[fi][keep], rows[j][keep], h[keep]

    # ----------------------------------------------------------- verify
    def _fit(self, p1, p2, w, cell, n_cells):
        """Affines [n_cells, 2, 3] by weighted least squares of the
        matches (p1 -> p2, weights w) of each cell."""
        x = torch.cat([p1, torch.ones_like(p1[:, :1])], 1)
        xw = x * w[:, None]
        a = torch.zeros((n_cells, 3, 3), dtype=F64, device=x.device)
        b = torch.zeros((n_cells, 3, 2), dtype=F64, device=x.device)
        a.index_add_(0, cell, self._r(xw[:, :, None] * x[:, None, :]))
        b.index_add_(0, cell, self._r(xw[:, :, None] * p2[:, None, :]))
        a = self._r(a) + 1e-6 * torch.eye(3, dtype=F64, device=x.device)
        sol = torch.linalg.solve_ex(a, self._r(b))[0]
        return self._r(sol.transpose(1, 2))

    @staticmethod
    def _inliers(m, f1, f2):
        """Transfer and scale test of models m [M, 2, 3], one a match."""
        px = m[:, 0, 0] * f1[:, 0] + m[:, 0, 1] * f1[:, 1] + m[:, 0, 2]
        py = m[:, 1, 0] * f1[:, 0] + m[:, 1, 1] * f1[:, 1] + m[:, 1, 2]
        err = (px - f2[:, 0]) ** 2 + (py - f2[:, 1]) ** 2
        det = torch.abs(m[:, 0, 0] * m[:, 1, 1] - m[:, 0, 1] * m[:, 1, 0])
        area_t = f1[:, 2] ** 2 * torch.clamp_min(det, 1e-12)
        area_m = f2[:, 2] ** 2 + 1e-12
        ratio = torch.maximum(area_t / area_m, area_m / area_t)
        return (err < THRESHOLD ** 2) & (ratio <= MAX_SCALE_ERROR ** 2)

    def pair_inliers(self, image: int, cands: torch.Tensor) -> torch.Tensor:
        """Effective inlier counts [len(cands)] float64 of the query
        image against each candidate."""
        dev = self.frames.device
        cands = torch.as_tensor(cands, dtype=torch.int64, device=dev)
        c = len(cands)
        slot, qr, dr_, h = self.matches(image, cands)
        k = one_to_one(slot, qr, dr_, h)
        slot, f1, f2 = slot[k], self.frames[qr[k]], self.frames[dr_[k]]
        if slot.numel() == 0:
            return torch.zeros(c, dtype=F64, device=dev)
        r = self._r
        # votes
        ds = r(torch.log2((f2[:, 2] + 1e-6) / (f1[:, 2] + 1e-6)))
        ang = f2[:, 3] - f1[:, 3]
        ang = r(torch.atan2(torch.sin(ang), torch.cos(ang)))
        s = r(2.0 ** ds)
        tx = r(f2[:, 0] - s * (torch.cos(ang) * f1[:, 0]
                               - torch.sin(ang) * f1[:, 1]))
        ty = r(f2[:, 1] - s * (torch.sin(ang) * f1[:, 0]
                               + torch.cos(ang) * f1[:, 1]))
        nt, nty, ns, nr = BINS
        coords = (_bin((tx / (2 * self.extent) + 0.5) * nt, nt),
                  _bin((ty / (2 * self.extent) + 0.5) * nty, nty),
                  _bin((ds / 8.0 + 0.5) * ns, ns),
                  _bin((ang / (2 * torch.pi) + 0.5) * nr, nr))

        def flat(cs):
            return ((cs[0] * nty + cs[1]) * ns + cs[2]) * nr + cs[3]
        n_bins = nt * nty * ns * nr
        b0 = flat(coords)
        hist = torch.zeros(c * n_bins, dtype=F64, device=dev).index_add_(
            0, slot * n_bins + b0, torch.ones_like(ds))
        score = hist.clone()
        for lvl in range(1, LEVELS):
            bl = flat([x >> lvl for x in coords])
            hl = torch.zeros_like(hist).index_add_(0, slot * n_bins + bl,
                                                   torch.ones_like(ds))
            # every bin's parent, with the finest strides
            allb = torch.arange(n_bins, device=dev)
            parent = flat([(allb // (nty * ns * nr)) >> lvl,
                           ((allb // (ns * nr)) % nty) >> lvl,
                           ((allb // nr) % ns) >> lvl, (allb % nr) >> lvl])
            score += 0.5 ** lvl * hl.reshape(c, n_bins)[:, parent].reshape(-1)
        score = torch.where(hist > 0, score, -1.0).reshape(c, n_bins)
        seeds = torch.sort(-score, dim=1, stable=True).indices[:, :SEEDS]

        # one affine a seed bin, from its matches
        in_seed = b0[:, None] == seeds[slot]                  # [M, S]
        w = in_seed.to(F64)
        idx = slot[:, None] * SEEDS + torch.arange(SEEDS, device=dev)
        models = self._fit(f1[:, :2].repeat_interleave(SEEDS, 0),
                           f2[:, :2].repeat_interleave(SEEDS, 0),
                           w.reshape(-1), idx.reshape(-1), c * SEEDS)
        models = models.reshape(c, SEEDS, 2, 3)
        inl = torch.stack([self._inliers(models[slot, j], f1, f2)
                           for j in range(SEEDS)], 1)
        support = torch.zeros((c, SEEDS), dtype=F64, device=dev).index_add_(
            0, slot, inl.to(F64))
        votes = torch.zeros((c, SEEDS), dtype=F64, device=dev).index_add_(
            0, slot, w)
        ok = torch.isfinite(models.reshape(c, SEEDS, 6)).all(-1) & (
            votes >= 3)
        support = torch.where(ok, support, 0.0)
        best = torch.argmax(support, 1)
        inl_best = inl[torch.arange(len(slot), device=dev), best[slot]]

        # the refit over the winner's inliers
        m2 = self._fit(f1[:, :2], f2[:, :2], inl_best.to(F64), slot, c)
        inl2 = self._inliers(m2[slot], f1, f2)
        n_w2 = torch.zeros(c, dtype=F64, device=dev).index_add_(
            0, slot, inl_best.to(F64))
        n2 = torch.zeros(c, dtype=F64, device=dev).index_add_(
            0, slot, inl2.to(F64))
        better = (torch.isfinite(m2.reshape(c, 6)).all(-1) & (n_w2 >= 3)
                  & (n2 >= support[torch.arange(c, device=dev), best]))
        inliers = torch.where(better[slot], inl2, inl_best)

        # effective inliers: occupied cells over the inliers' box
        box = []
        for v, fill, how in ((f1[:, 0], float("inf"), "amin"),
                             (f1[:, 0], -float("inf"), "amax"),
                             (f1[:, 1], float("inf"), "amin"),
                             (f1[:, 1], -float("inf"), "amax")):
            box.append(torch.full((c,), fill, dtype=F64,
                                  device=dev).scatter_reduce(
                0, slot, torch.where(inliers, v, fill), how))
        lo_x, hi_x, lo_y, hi_y = box
        sx = EFF_BINS / torch.clamp_min(hi_x - lo_x, 1e-6)
        sy = EFF_BINS / torch.clamp_min(hi_y - lo_y, 1e-6)
        cell = (_bin((f1[:, 0] - lo_x[slot]) * sx[slot], EFF_BINS) * EFF_BINS
                + _bin((f1[:, 1] - lo_y[slot]) * sy[slot], EFF_BINS))
        grid = torch.zeros(c * EFF_BINS * EFF_BINS, dtype=F64, device=dev)
        grid[(slot * EFF_BINS * EFF_BINS + cell)[inliers]] = 1.0
        return grid.reshape(c, -1).sum(1)

    # ----------------------------------------------------------- scores
    def candidates(self, images) -> torch.Tensor:
        """Each query image's `verify` best images by the normalised
        score [S, C]."""
        s = self.base.scores(images)
        return self.base.best(s, min(self.verify, self.base.n_images))[1]

    def verified(self, images, ids):
        """(verified scores [S, n_images]: the normalised scores with the
        effective inliers of each query's candidates added; the verified
        scores of `ids` [S, k] (None for None), each id verified whether
        it is a candidate or not)."""
        images = torch.as_tensor(images, dtype=torch.int64,
                                 device=self.frames.device)
        s = self.base.scores(images)
        cands = self.base.best(s, min(self.verify, self.base.n_images))[1]
        ver = s.clone()
        got = None if ids is None else torch.gather(s, 1, ids.clamp(
            0, self.base.n_images - 1))
        for i, q in enumerate(images.tolist()):
            want = cands[i] if ids is None else torch.unique(
                torch.cat([cands[i], ids[i].clamp(0, self.base.n_images - 1)]))
            eff = torch.zeros(self.base.n_images, dtype=F64,
                              device=s.device)
            eff[want] = self.pair_inliers(q, want)
            ver[i, cands[i]] += eff[cands[i]]
            if ids is not None:
                got[i] += eff[ids[i].clamp(0, self.base.n_images - 1)]
        return ver, got

    def candidate_entries(self, images, cands) -> int:
        """The entries, counted once, of the lists that the query images'
        words walk whose image is a candidate (`cands` [S, C]) of a query
        image with a feature of that list's word. The database's rows are
        the entries, one each."""
        b = self.base
        dev = self.frames.device
        images = torch.as_tensor(images, dtype=torch.int64, device=dev)
        cands = torch.as_tensor(cands, dtype=torch.int64, device=dev)
        fw, _, fq = b.features(images)
        walked = torch.unique(fq * b.n_words + fw)      # (query, word)
        q = torch.arange(len(images), device=dev).repeat_interleave(
            cands.shape[1])
        a = b.img_off[cands.reshape(-1)]
        n = b.img_off[cands.reshape(-1) + 1] - a
        rows = torch.repeat_interleave(a - (torch.cumsum(n, 0) - n), n) + \
            torch.arange(int(n.sum()), device=dev)
        key = torch.repeat_interleave(q, n) * b.n_words + b.words[rows]
        pos = torch.searchsorted(walked, key).clamp_max(len(walked) - 1)
        return int(torch.unique(rows[walked[pos] == key]).numel())

    def records(self, images, cands) -> int:
        """The matches before the 1-to-1 rule of each query image with its
        candidates, in all."""
        return sum(int(self.matches(int(q), c)[0].numel())
                   for q, c in zip(images, cands))
