"""The vocabulary-tree kind: an image collection's SIFT-like descriptors,
a two-level tree and the Hamming embedding's projection and thresholds as
the deployment's inputs; the same images, held in host memory, as its
query pool; the plain float64 reference (benchmark/reference/vocab.py)
and the gaps of the program's top k from the reference's as the numbers
that decide `correct`.

Everything is made from the seed on the run's device by plain code
(`assumed` in the configuration says what stands in for what):

  * rows per image: log-normal about the configuration's mean, clipped;
  * descriptors: data.py's mixture over `centres` gamma centres with a
    Zipf popularity; images in groups of `group` consecutive ids, each
    group a scene of `scene_rows` rows, a share of each image's rows
    noisy copies of its scene's, a share repeats of its own rows, the
    rest fresh draws; uint8;
  * the tree: `coarse_iters` k-means steps over `coarse_sample` training
    rows (data.kmeans: float32 products, sums with no atomics), then each
    coarse cell's words drawn from its training rows (rows drawn with
    even centre popularity, as the tree is trained on another
    collection), the cell's coarse centroid rounded where none is;
  * the projection: the first `bits` columns of data.rotation;
  * the thresholds: per word and bit, the median of the training rows'
    projections (each row in its nearest coarse cell's nearest word), the
    global median for a word without a row (inverted_file.h:276-292).

Images are the queries: a batch is a run of consecutive images, its rows
a view of one flat uint8 array.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import data
from benchmark.reference import vocab as ref_vocab


class Batch:
    """Consecutive images of the pool: rows [sum(counts), D] uint8 (a
    view) and counts [n]."""

    def __init__(self, rows: np.ndarray, counts: np.ndarray):
        self.rows, self.counts = rows, counts


class Pool:
    """The collection's images in host memory, sliced by image."""

    def __init__(self, rows: np.ndarray, counts: np.ndarray):
        self.rows, self.counts = rows, counts
        self.offsets = np.concatenate([[0], np.cumsum(counts)])
        self.shape = (len(counts),)

    def __getitem__(self, s: slice) -> Batch:
        a, b, _ = s.indices(len(self.counts))
        return Batch(self.rows[self.offsets[a]:self.offsets[b]],
                     self.counts[a:b])


def image_counts(cfg: dict, seed: int) -> np.ndarray:
    """Rows per image [n_images] int64."""
    d = cfg["data"]
    rng = np.random.default_rng(data.seed_for(seed, "vocab-counts"))
    s = d["count_sigma"]
    c = rng.lognormal(np.log(cfg["mean_per_image"]) - s * s / 2, s,
                      cfg["n_images"])
    return np.clip(np.round(c), d["count_min"], d["count_max"]).astype(
        np.int64)


def _noisy(x: torch.Tensor, sigma: float, g) -> torch.Tensor:
    y = x + sigma * torch.randn(x.shape, generator=g, device=x.device)
    return torch.clamp(y, 0.0, 255.0).round()


def _zipf_cdf(n: int, s: float, dev) -> torch.Tensor:
    w = torch.arange(1, n + 1, dtype=torch.float64, device=dev) ** -s
    return torch.cumsum(w / w.sum(), 0)


def _mixture(cfg: dict, seed: int, dev):
    d = cfg["data"]
    g = data.generator(seed, "vocab-centres", dev)
    alpha = torch.full((d["centres"], cfg["dim"]), 1.2, device=dev)
    return torch._standard_gamma(alpha, generator=g) * 24.0


def _draw(centres, m: int, g, noise: float, cdf=None) -> torch.Tensor:
    """m rows float32 of the mixture, centres drawn evenly or by `cdf`."""
    nc = centres.shape[0]
    if cdf is None:
        ci = torch.randint(0, nc, (m,), generator=g, device=centres.device)
    else:
        u = torch.rand(m, generator=g, device=centres.device,
                       dtype=torch.float64)
        ci = torch.searchsorted(cdf, u).clamp_max(nc - 1)
    return _noisy(centres[ci], noise, g)


def database(cfg: dict, seed: int, dev) -> tuple[torch.Tensor, np.ndarray]:
    """(descriptors [N, D] uint8 on `dev`, rows per image [n_images])."""
    d = cfg["data"]
    counts = image_counts(cfg, seed)
    centres = _mixture(cfg, seed, dev)
    cdf = _zipf_cdf(d["centres"], d["zipf"], dev)
    g = data.generator(seed, "vocab-database", dev)
    n_img, dim = len(counts), cfg["dim"]
    n_groups = -(-n_img // d["group"])
    scene = _draw(centres, n_groups * d["scene_rows"], g, d["noise"],
                  cdf).to(torch.uint8)
    cnt = torch.as_tensor(counts, device=dev)
    img = torch.repeat_interleave(torch.arange(n_img, device=dev), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(img.shape[0], device=dev) - start[img]
    # the last `repeat` share of an image's rows repeat its earlier rows
    n_base = torch.clamp_min(torch.round(cnt * (1.0 - d["repeat"])).long(),
                             1)
    out = torch.empty((img.shape[0], dim), dtype=torch.uint8, device=dev)
    for lo in range(0, img.shape[0], data.CHUNK):
        i, p = img[lo:lo + data.CHUNK], pos[lo:lo + data.CHUNK]
        m = i.shape[0]
        fresh = _draw(centres, m, g, d["noise"], cdf)
        pick = torch.randint(0, d["scene_rows"], (m,), generator=g,
                             device=dev)
        copy = _noisy(scene[(i // d["group"]) * d["scene_rows"]
                            + pick].float(), d["shared_noise"], g)
        shared = torch.rand(m, generator=g, device=dev) < d["shared"]
        out[lo:lo + m] = torch.where(shared[:, None], copy, fresh).to(
            torch.uint8)
    # repeats copy a row of the image's first n_base rows, with noise
    rep = torch.nonzero(pos >= n_base[img])[:, 0]
    src = start[img[rep]] + (torch.rand(rep.shape[0], generator=g,
                                        device=dev)
                             * n_base[img[rep]]).long()
    out[rep] = _noisy(out[src].float(), d["repeat_noise"], g).to(torch.uint8)
    return out, counts


def tree(cfg: dict, seed: int, dev):
    """(coarse [K1, D], fine [K1, K2, D], training rows [T, D] float32)."""
    t = cfg["tree"]
    d = cfg["data"]
    k1, k2 = t["coarse"], t["fine"]
    centres = _mixture(cfg, seed, dev)
    g = data.generator(seed, "vocab-tree", dev)
    train = torch.empty((t["train_rows"], cfg["dim"]), device=dev)
    for lo in range(0, t["train_rows"], data.CHUNK):
        m = min(data.CHUNK, t["train_rows"] - lo)
        train[lo:lo + m] = _draw(centres, m, g, d["noise"])
    coarse = data.kmeans(train[:t["coarse_sample"]], k1, t["coarse_iters"],
                         g)
    cell = torch.cat([data._assign(train[lo:lo + data.CHUNK], coarse, 32_768)
                      for lo in range(0, t["train_rows"], data.CHUNK)])
    # each cell's words: its training rows in a random order, cycled
    # where it holds fewer than K2
    key = torch.rand(t["train_rows"], generator=g, device=dev,
                     dtype=torch.float64) + cell.double()
    order = torch.argsort(key)
    counts = torch.bincount(cell, minlength=k1)
    first = torch.cumsum(counts, 0) - counts
    j = torch.arange(k2, device=dev)[None, :] % counts.clamp_min(1)[:, None]
    fine = train[order[(first[:, None] + j).clamp_max(t["train_rows"] - 1)]]
    empty = (counts == 0)[:, None, None]
    fine = torch.where(empty, coarse.round()[:, None, :], fine)
    return coarse, fine.contiguous(), train


def thresholds(cfg: dict, train, coarse, fine, proj) -> torch.Tensor:
    """[W, bits] float32: per word, the median of its training rows'
    projections (mean of the middle two), the global median where a word
    has none."""
    k1, k2, _ = fine.shape
    w = ref_vocab.assign(train, coarse, fine, 1)
    p = train @ proj                                        # [T, bits]
    n_words = k1 * k2
    counts = torch.bincount(w, minlength=n_words)
    first = torch.cumsum(counts, 0) - counts
    lo = first + torch.div(torch.clamp_min(counts - 1, 0), 2,
                           rounding_mode="floor")
    hi = first + torch.div(torch.clamp_min(counts, 1), 2,
                           rounding_mode="floor")
    last = p.shape[0] - 1
    lo, hi = lo.clamp_max(last), hi.clamp_max(last)
    # each column sorted by value, then (stably) by word: every word's
    # values contiguous and in order
    by_value = torch.sort(p, dim=0, stable=True)
    col = by_value.values
    order = torch.sort(w[by_value.indices], dim=0, stable=True).indices
    col = torch.gather(col, 0, order)
    thr = 0.5 * (col[lo] + col[hi])
    s = by_value.values
    glob = 0.5 * (s[last // 2] + s[(last + 1) // 2])
    return torch.where((counts == 0)[:, None], glob[None, :], thr)


def inputs(cfg: dict, seed: int, dev) -> tuple[dict, dict]:
    """The descriptors, the tree, the HE projection and thresholds, and
    the seconds each took."""
    t0 = time.perf_counter()
    desc, counts = database(cfg, seed, dev)
    data.sync(dev)
    t1 = time.perf_counter()
    coarse, fine, train = tree(cfg, seed, dev)
    data.sync(dev)
    t2 = time.perf_counter()
    g = data.generator(seed, "vocab-he", dev)
    proj = data.rotation(cfg["dim"], g)[:, :cfg["he"]["bits"]].contiguous()
    thr = thresholds(cfg, train, coarse, fine, proj)
    data.sync(dev)
    out = {"descriptors": desc, "counts": counts, "coarse": coarse,
           "fine": fine, "he_proj": proj, "he_thresh": thr}
    return out, {"data_s": t1 - t0, "tree_s": t2 - t1,
                 "he_s": time.perf_counter() - t2,
                 "descriptors": int(counts.sum())}


def query_pool(cfg: dict, traffic: dict, seed: int, dev) -> Pool:
    """The collection's images in host memory: flat uint8 rows and the
    rows per image (traffic["pool"] images, the collection's own)."""
    desc, counts = database(cfg, seed, dev)
    n = traffic["pool"]
    rows = desc[:int(counts[:n].sum())].cpu().numpy()
    return Pool(rows, counts[:n])


def reference(cfg: dict, inputs: dict):
    t, he = cfg["tree"], cfg["he"]
    return ref_vocab.VocabRef(inputs["descriptors"], inputs["counts"],
                              inputs["coarse"], inputs["fine"],
                              inputs["he_proj"], inputs["he_thresh"],
                              t["probes"], he["max_dist"], he["sigma"])


def _gaps(ref, rows, ids, scores) -> dict:
    """The numbers of the program's answers (ids, scores [S, k]) to the
    query images `rows` [S] against the reference."""
    s_ref = ref.scores(rows)                              # [S, n] float64
    k = ids.shape[1]
    best, _ = ref.best(s_ref, k)
    first = best[:, :1]
    n = ref.n_images
    got = torch.gather(s_ref, 1, ids.clamp(0, n - 1))
    gap = (best - got) / first
    err = (scores.double() - got).abs() / first
    srt = torch.sort(ids, dim=1).values
    bad = int(((ids < 0) | (ids >= n)).sum()) + int(
        (srt[:, 1:] == srt[:, :-1]).sum())
    return {"bad_ids": bad,
            "top1_gap": max(0.0, float(gap[:, 0].max())),
            "rank_gap": max(0.0, float(gap.max())),
            "score_err": float(err.max()),
            "score_err_med": float(err.median())}


def _sample(win, dev):
    rows = torch.as_tensor(win.sample_rows, device=dev).long()
    ids = torch.as_tensor(win.sample_ids, device=dev).long()
    scores = torch.as_tensor(win.sample_dists, device=dev)
    return rows, ids, scores


def numbers(ref, cfg: dict, traffic: dict, pool, win, dev) -> dict:
    """bad_ids, top1_gap, rank_gap (j = 1..k: the reference's j-th best
    score less its score of the program's j-th id, over the reference's
    first score), score_err and score_err_med (the widest and the median
    gap of a returned score from the reference's score of that id, over
    the first score) on the window's sample, and the window's unanswered
    queries. A changed word moves the few scores that hold it, and so
    score_err; a coarser signing or term weight moves nearly every
    score, and so score_err_med."""
    out = {"unanswered": win.failed}
    if win.sample_rows is None:
        return out
    out.update(_gaps(ref, *_sample(win, dev)))
    return out


def informative(ref, inputs: dict, pool, win, dev) -> dict:
    """The share of sampled queries answered first by themselves, the
    longest posting list, the size-biased mean list length, and the
    pairs of a query feature and a list entry a batch of the traffic
    walks (averaged over the pool's whole batches)."""
    if win.sample_rows is None:
        return {}
    rows, ids, _ = _sample(win, dev)
    lengths = ref.lengths.double()
    batch = max(1, win.attempted // max(1, win.extra.get("batches", 1)))
    per_pool = pool.shape[0] // batch
    return {"self_at_1": float((ids[:, 0] == rows).double().mean()),
            "longest_list": int(ref.lengths.max()),
            "list_size_biased_mean": float((lengths ** 2).sum()
                                           / lengths.sum()),
            "pairs_per_batch": ref.pairs(torch.arange(per_pool * batch))
            / max(1, per_pool)}


def control(ref, cfg: dict, traffic: dict, pool, win, dev) -> dict:
    """The numbers of the reference computed in bfloat16 (its descent,
    projection and term weights: `VocabRef.control`) on the window's
    sample, its top k taken as the program's answers; beside them, under
    `signing_<number>`, those of `VocabRef.signing_control` (the
    projection and term weights alone in bfloat16)."""
    rows, _, _ = _sample(win, dev)
    out = {"unanswered": 0}
    for prefix, ctrl in (("", ref.control()),
                         ("signing_", ref.signing_control())):
        v, i = ctrl.best(ctrl.scores(rows), traffic["k"])
        out.update({prefix + k: x
                    for k, x in _gaps(ref, rows, i, v.float()).items()})
    return out
