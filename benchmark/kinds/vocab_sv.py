"""The vocabulary-tree kind with spatial re-ranking: the vocab kind's
collection, tree and Hamming embedding, with a keypoint frame (x, y,
scale, orientation) for every descriptor; each query image's `verify`
best images are re-scored by vote-and-verify. The plain reference is
benchmark/reference/vocab_sv.py over the vocab kind's VocabRef.

The generator, the tree and the thresholds are the vocab kind's
(benchmark/kinds/vocab.py, not edited). The database is drawn again here
under this kind's own seed names, with each row's provenance kept, so
that the frames can follow it (`assumed` in the configuration):

  * each group's scene rows get frames uniform over the scene (the
    configuration's `frames.width` x `frames.height`), scale log-uniform
    in `frames.scale`, orientation uniform;
  * each image sees its group's scene through a similarity about the
    scene's centre: scale 2^U(-s, s), rotation U(-r, r), shift up to a
    share of the scene's sides;
  * a copied row takes its scene row's frame mapped by that similarity,
    with noise in position (px), scale (a share) and orientation;
  * a fresh row's frame is uniform as a scene row's;
  * a repeat takes its source row's frame with noise in position.

The numbers that decide `correct`, on the window's sample, against the
reference's verified scores (its normalised score, plus the
vote-and-verify score of each of its own `verify` best images):
`unanswered`, `bad_ids`, `top1_gap`, `rank_gap`, `score_err` and
`score_err_med` as the vocab kind defines them; `inlier_gap`, the
largest gap of a non-self answer's score from the reference's verified
score of that image, in effective inliers (the normalised parts differ
by less than 1e-3 of one), and `inlier_gap_med`, its median.
"""

from __future__ import annotations

import math
import time

import torch

from benchmark import data
from benchmark.kinds import vocab as kind_vocab
from benchmark.reference import vocab_sv as ref_sv


class Batch(kind_vocab.Batch):
    """Consecutive images of the pool: rows [sum(counts), D] uint8,
    counts [n] and frames [sum(counts), 4] float32 (views)."""

    def __init__(self, rows, counts, frames):
        super().__init__(rows, counts)
        self.frames = frames


class Pool(kind_vocab.Pool):
    """The collection's images and their frames in host memory."""

    def __init__(self, rows, counts, frames):
        super().__init__(rows, counts)
        self.frames = frames

    def __getitem__(self, s: slice) -> Batch:
        a, b, _ = s.indices(len(self.counts))
        lo, hi = self.offsets[a], self.offsets[b]
        return Batch(self.rows[lo:hi], self.counts[a:b], self.frames[lo:hi])


def _log_uniform(m, lo, hi, g, dev):
    u = torch.rand(m, generator=g, device=dev)
    return torch.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))


def _uniform_frames(m: int, fr: dict, g, dev) -> torch.Tensor:
    out = torch.empty((m, 4), device=dev)
    out[:, 0] = torch.rand(m, generator=g, device=dev) * fr["width"]
    out[:, 1] = torch.rand(m, generator=g, device=dev) * fr["height"]
    out[:, 2] = _log_uniform(m, *fr["scale"], g, dev)
    out[:, 3] = (torch.rand(m, generator=g, device=dev) * 2 - 1) * math.pi
    return out


def database(cfg: dict, seed: int, dev):
    """(descriptors [N, D] uint8, rows per image [n_images], frames [N, 4]
    float32), all made from the seed on `dev`: the vocab kind's database
    drawn with each row's provenance, then the frames that follow it."""
    d, fr = cfg["data"], cfg["frames"]
    counts = kind_vocab.image_counts(cfg, seed)
    centres = kind_vocab._mixture(cfg, seed, dev)
    cdf = kind_vocab._zipf_cdf(d["centres"], d["zipf"], dev)
    g = data.generator(seed, "vocab-sv-database", dev)
    n_img, dim = len(counts), cfg["dim"]
    n_groups = -(-n_img // d["group"])
    scene = kind_vocab._draw(centres, n_groups * d["scene_rows"], g,
                             d["noise"], cdf).to(torch.uint8)
    cnt = torch.as_tensor(counts, device=dev)
    img = torch.repeat_interleave(torch.arange(n_img, device=dev), cnt)
    start = torch.cumsum(cnt, 0) - cnt
    pos = torch.arange(img.shape[0], device=dev) - start[img]
    n_base = torch.clamp_min(torch.round(cnt * (1.0 - d["repeat"])).long(),
                             1)
    out = torch.empty((img.shape[0], dim), dtype=torch.uint8, device=dev)
    # the scene row each row copies, or -1 for a fresh draw
    from_scene = torch.full((img.shape[0],), -1, dtype=torch.int64,
                            device=dev)
    for lo in range(0, img.shape[0], data.CHUNK):
        i, p = img[lo:lo + data.CHUNK], pos[lo:lo + data.CHUNK]
        m = i.shape[0]
        fresh = kind_vocab._draw(centres, m, g, d["noise"], cdf)
        pick = ((i // d["group"]) * d["scene_rows"]
                + torch.randint(0, d["scene_rows"], (m,), generator=g,
                                device=dev))
        copy = kind_vocab._noisy(scene[pick].float(), d["shared_noise"], g)
        shared = torch.rand(m, generator=g, device=dev) < d["shared"]
        out[lo:lo + m] = torch.where(shared[:, None], copy, fresh).to(
            torch.uint8)
        from_scene[lo:lo + m] = torch.where(shared, pick, -1)
    rep = torch.nonzero(pos >= n_base[img])[:, 0]
    src = start[img[rep]] + (torch.rand(rep.shape[0], generator=g,
                                        device=dev)
                             * n_base[img[rep]]).long()
    out[rep] = kind_vocab._noisy(out[src].float(), d["repeat_noise"],
                                 g).to(torch.uint8)

    # the frames
    gf = data.generator(seed, "vocab-sv-frames", dev)
    scene_f = _uniform_frames(n_groups * d["scene_rows"], fr, gf, dev)
    view_s = 2.0 ** ((torch.rand(n_img, generator=gf, device=dev) * 2 - 1)
                     * fr["view_log2_scale"])
    view_r = ((torch.rand(n_img, generator=gf, device=dev) * 2 - 1)
              * math.radians(fr["view_degrees"]))
    size = torch.tensor([fr["width"], fr["height"]], device=dev)
    view_t = ((torch.rand((n_img, 2), generator=gf, device=dev) * 2 - 1)
              * fr["view_shift"] * size)
    frames = _uniform_frames(img.shape[0], fr, gf, dev)
    cp = torch.nonzero(from_scene >= 0)[:, 0]
    sf, vi = scene_f[from_scene[cp]], img[cp]
    s, r = view_s[vi], view_r[vi]
    c, sn = torch.cos(r), torch.sin(r)
    xy = sf[:, :2] - size / 2
    noise = torch.randn((cp.shape[0], 4), generator=gf, device=dev)
    frames[cp, 0] = (s * (c * xy[:, 0] - sn * xy[:, 1]) + size[0] / 2
                     + view_t[vi, 0] + fr["copy_px"] * noise[:, 0])
    frames[cp, 1] = (s * (sn * xy[:, 0] + c * xy[:, 1]) + size[1] / 2
                     + view_t[vi, 1] + fr["copy_px"] * noise[:, 1])
    frames[cp, 2] = sf[:, 2] * s * (1.0 + fr["copy_scale"] * noise[:, 2])
    frames[cp, 3] = (sf[:, 3] + r
                     + math.radians(fr["copy_degrees"]) * noise[:, 3])
    frames[rep] = frames[src]
    frames[rep, :2] += fr["repeat_px"] * torch.randn(
        (rep.shape[0], 2), generator=gf, device=dev)
    return out, counts, frames


def inputs(cfg: dict, seed: int, dev) -> tuple[dict, dict]:
    """The vocab kind's inputs, on this kind's database with its frames,
    and the seconds each part took."""
    t0 = time.perf_counter()
    desc, counts, frames = database(cfg, seed, dev)
    data.sync(dev)
    t1 = time.perf_counter()
    coarse, fine, train = kind_vocab.tree(cfg, seed, dev)
    data.sync(dev)
    t2 = time.perf_counter()
    g = data.generator(seed, "vocab-he", dev)
    proj = data.rotation(cfg["dim"], g)[:, :cfg["he"]["bits"]].contiguous()
    thr = kind_vocab.thresholds(cfg, train, coarse, fine, proj)
    data.sync(dev)
    out = {"descriptors": desc, "counts": counts, "frames": frames,
           "coarse": coarse, "fine": fine, "he_proj": proj,
           "he_thresh": thr, "group": cfg["data"]["group"]}
    return out, {"data_s": t1 - t0, "tree_s": t2 - t1,
                 "he_s": time.perf_counter() - t2,
                 "descriptors": int(counts.sum())}


def query_pool(cfg: dict, traffic: dict, seed: int, dev) -> Pool:
    """The collection's first traffic["pool"] images in host memory: flat
    uint8 rows, rows per image and float32 frames."""
    desc, counts, frames = database(cfg, seed, dev)
    n = traffic["pool"]
    m = int(counts[:n].sum())
    return Pool(desc[:m].cpu().numpy(), counts[:n],
                frames[:m].cpu().numpy())


def reference(cfg: dict, inputs: dict):
    return ref_sv.VerifiedRef(kind_vocab.reference(cfg, inputs),
                              inputs["frames"], cfg["verify"],
                              cfg["image_extent"])


def _numbers(ref, rows, ids, scores, k: int) -> dict:
    """The numbers of answers (ids, scores [S, k]) to the query images
    `rows` [S], each answer's score taken as verified."""
    ver, got = ref.verified(rows, ids)
    best, _ = ref.base.best(ver, k)
    first = best[:, :1]
    n = ref.base.n_images
    gap = (best - got) / first
    err = (scores.double() - got).abs()
    srt = torch.sort(ids, dim=1).values
    bad = int(((ids < 0) | (ids >= n)).sum()) + int(
        (srt[:, 1:] == srt[:, :-1]).sum())
    other = ids != rows[:, None]
    return {"bad_ids": bad,
            "top1_gap": max(0.0, float(gap[:, 0].max())),
            "rank_gap": max(0.0, float(gap.max())),
            "score_err": float((err / first).max()),
            "score_err_med": float((err / first).median()),
            "inlier_gap": float(err[other].max()) if other.any() else 0.0,
            "inlier_gap_med": (float(err[other].median()) if other.any()
                               else 0.0)}


def numbers(ref, cfg: dict, traffic: dict, pool, win, dev) -> dict:
    """The vocab kind's numbers against the reference's verified scores,
    and the inlier gaps of the non-self answers, on the window's sample;
    the window's unanswered queries. The program verifies every image it
    returns (`verify` at least k)."""
    if cfg["verify"] < traffic["k"]:
        raise ValueError("the vocab_sv kind verifies every answer: "
                         "verify must be at least k")
    out = {"unanswered": win.failed}
    if win.sample_rows is None:
        return out
    out.update(_numbers(ref, *kind_vocab._sample(win, dev), traffic["k"]))
    return out


def informative(ref, inputs: dict, pool, win, dev) -> dict:
    """The vocab kind's informative numbers; the records a batch of the
    traffic makes (the pairs of a query feature and an entry of a
    candidate image within the Hamming limit, from the reference's
    candidates of the sampled queries), the pairs verified in the window,
    and the median effective inliers of the reference's same-group and
    other non-self pairs of the sample."""
    out = kind_vocab.informative(ref.base, inputs, pool, win, dev)
    if win.sample_rows is None:
        return out
    rows, _, _ = kind_vocab._sample(win, dev)
    batch = max(1, win.attempted // max(1, win.extra.get("batches", 1)))
    cands = ref.candidates(rows)
    eff = torch.stack([ref.pair_inliers(int(r), c)
                       for r, c in zip(rows, cands)])
    group = inputs["group"]
    same = (cands // group == rows[:, None] // group) & (cands
                                                         != rows[:, None])
    other = cands // group != rows[:, None] // group
    out.update({
        "records_per_batch": ref.records(rows, cands) / len(rows) * batch,
        "verified_pairs": win.queries * min(ref.verify, ref.base.n_images),
        "inliers_same_group_med": (float(eff[same].median()) if same.any()
                                   else 0.0),
        "inliers_other_med": (float(eff[other].median()) if other.any()
                              else 0.0)})
    return out


def control(ref, cfg: dict, traffic: dict, pool, win, dev) -> dict:
    """The numbers of the reference with its frames, votes and affine fits
    in bfloat16 (`VerifiedRef.control`) on the window's sample, its
    verified top k taken as the program's answers; beside them, under
    `signing_<number>`, those of `VerifiedRef.signing_control` (the
    normalised scores' projection and term weights alone in bfloat16),
    which move every score a little: the medians' control."""
    rows, _, _ = kind_vocab._sample(win, dev)
    out = {"unanswered": 0}
    for prefix, ctrl in (("", ref.control()),
                         ("signing_", ref.signing_control())):
        ver, _ = ctrl.verified(rows, None)
        v, i = ref.base.best(ver, traffic["k"])
        out.update({prefix + k: x for k, x in _numbers(
            ref, rows, i, v.float(), traffic["k"]).items()})
    return out
