"""Spatial verification of the vocabulary tree on the ragged batch
(`VocabHEIndex.query_batch(rows, counts=, geometries=, verify=)`), on the
CPU at the size of a test:

  * `vocab_match`'s twin against a plain nested-loop walk of the lists:
    empty lists, features without a word, queries without a candidate,
    Hamming distances 24 and 25;
  * the records' 1-to-1 rule (`_one_to_one`) against the padded form's
    (`_candidate_matches`) on the same images: the same kept matches,
    pair by pair, whatever order the records come in;
  * `vote_and_verify_segmented` against `vote_and_verify` set by set;
  * the ragged verified query against the padded one on the same images;
  * the benchmark's plain float64 reference (benchmark/reference/
    vocab_sv.py) against the port.

Tolerances, each for its reason. The segmented form fits its affines in
float64 (`fit_affine_segmented`), the padded form in float32: where a
set's winning seed bin holds at least 3 matches the fits agree to float32
rounding and so do the counts here; where every seed bin holds one or two
matches, the padded form's float32 solve of a system singular but for its
1e-6 regularisation is rounding noise, and the few matches such a model
carries may count differently: there the verification parts may differ,
by at most 2 inliers on these collections. The unverified parts are the
same computation in both forms and equal.
"""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.kinds import vocab_sv as kind_sv
from benchmark.reference import vocab as ref_vocab
from benchmark.reference import vocab_sv as ref_sv
from cvt_tpu_torch.index import VocabHEIndex
from cvt_tpu_torch.index import vocab_he as tv
from cvt_tpu_torch.match.vote_verify import (vote_and_verify,
                                             vote_and_verify_segmented)
from cvt_tpu_torch.ops.kernels import vocab_match as VM

SMALL = {"n_images": 32, "mean_per_image": 120,
         "tree": {"coarse": 16, "fine": 16, "probes": 4, "train_rows": 8192,
                  "coarse_sample": 4096, "coarse_iters": 3},
         "data": {"centres": 512, "scene_rows": 192, "count_min": 24,
                  "count_max": 400, "group": 4}}


@pytest.fixture(scope="module", params=[11, 12])
def collection(request):
    """The benchmark's collection with frames at a test's size, and the
    index built from it on the CPU."""
    cfg = harness._merge(harness.Registry().config(
        "oxford5k-vt1m-he64-sv100"), SMALL)
    inputs, _ = kind_sv.inputs(cfg, request.param, "cpu")
    t = cfg["tree"]
    idx = VocabHEIndex(n_words=t["coarse"] * t["fine"], dim=cfg["dim"],
                       hierarchical=True, probes=t["probes"], device="cpu")
    idx.coarse, idx.fine = inputs["coarse"], inputs["fine"]
    idx.words = idx.fine.reshape(-1, cfg["dim"])
    idx.he_proj, idx.he_thresh = inputs["he_proj"], inputs["he_thresh"]
    idx.add_images(inputs["descriptors"], inputs["counts"],
                   geometries=inputs["frames"])
    idx.prepare()
    return cfg, inputs, idx


def _batch(inputs, images):
    off = np.concatenate([[0], np.cumsum(inputs["counts"])])
    rows = np.concatenate([np.arange(off[i], off[i + 1]) for i in images])
    return (inputs["descriptors"][rows], inputs["counts"][images],
            inputs["frames"][rows], rows)


# ------------------------------------------------------------ vocab_match

def _nested_walk(f_word, f_sig, f_query, offsets, e_img, e_sig, e_feat,
                 cand, max_dist):
    out = []
    for f in range(len(f_word)):
        w = int(f_word[f])
        if w < 0:
            continue
        for e in range(int(offsets[w]), int(offsets[w + 1])):
            slot = int(cand[int(f_query[f]), int(e_img[e])])
            h = bin((int(f_sig[f]) ^ int(e_sig[e])) & (2 ** 64 - 1)).count(
                "1")
            if slot >= 0 and h <= max_dist:
                out.append((slot, f, int(e_feat[e]), h))
    return torch.tensor(out, dtype=torch.int32).reshape(-1, 4)


def _lists(lengths, n_images, g):
    lengths = torch.as_tensor(lengths, dtype=torch.int64)
    off = torch.zeros(len(lengths) + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(lengths, 0)
    e = int(off[-1])
    img = torch.randint(0, n_images, (e,), generator=g, dtype=torch.int32)
    sig = torch.randint(-2 ** 63, 2 ** 63 - 1, (e,), generator=g,
                        dtype=torch.int64)
    return off, img, sig, torch.randperm(e, generator=g).int()


def _flip(sig, bits, g):
    """Each signature with `bits` distinct bits flipped."""
    out = sig.clone()
    for i in range(len(sig)):
        for b in torch.randperm(64, generator=g)[:bits].tolist():
            out[i] ^= torch.tensor(-2 ** 63 if b == 63 else 1 << b)
    return out


@pytest.mark.parametrize("case", ["mixed", "empty_lists", "no_candidate",
                                  "limit"])
def test_match_twin_against_nested_walk(case):
    g = torch.Generator().manual_seed(3)
    n_images, q = 9, 3
    lengths = {"mixed": [5, 0, 17, 3, 0, 40, 1, 8],
               "empty_lists": [0] * 8, "no_candidate": [5, 7, 9, 2, 4, 6,
                                                        8, 3],
               "limit": [30] * 8}[case]
    off, img, sig, feat = _lists(lengths, n_images, g)
    n_feat = 40
    f_word = torch.randint(-1, 8, (n_feat,), generator=g, dtype=torch.int32)
    f_query = torch.randint(0, q, (n_feat,), generator=g, dtype=torch.int32)
    if case == "limit":
        # each feature's signature 24 or 25 bits from its word's first
        # entry's
        first = sig[off[f_word.clamp_min(0).long()].clamp_max(
            len(sig) - 1)]
        bits = torch.where(torch.arange(n_feat) % 2 == 0, 24, 25)
        f_sig = torch.stack([_flip(first[i:i + 1], int(bits[i]), g)[0]
                             for i in range(n_feat)])
    else:
        f_sig = torch.randint(-2 ** 63, 2 ** 63 - 1, (n_feat,), generator=g,
                              dtype=torch.int64)
    cand = torch.full((q, n_images), -1, dtype=torch.int32)
    if case != "no_candidate":
        for j in range(q):
            pick = torch.randperm(n_images, generator=g)[:4]
            cand[j, pick] = torch.arange(4, dtype=torch.int32) + 4 * j
    max_dist = 24 if case == "limit" else 40
    args = (f_word, f_sig, f_query, off, img, sig, feat, cand, max_dist)
    want = _nested_walk(*args)
    got = VM.vocab_match(*args)
    assert torch.equal(got, want)
    if case in ("empty_lists", "no_candidate"):
        assert got.shape == (0, 4)
    if case == "limit":
        assert set(got[:, 3].tolist()) <= set(range(25))
        assert (got[:, 3] == 24).any()


def test_match_counters():
    g = torch.Generator().manual_seed(4)
    off, img, sig, feat = _lists([6, 2, 9], 4, g)
    f_word = torch.tensor([0, 2, -1, 2], dtype=torch.int32)
    cand = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    args = (f_word, sig[:4].clone(), torch.tensor([0, 1, 1, 0],
                                                  dtype=torch.int32),
            off, img, sig, feat, cand, 64)
    before = VM.vocab_match.counters()
    out = VM.vocab_match(*args)
    after = VM.vocab_match.counters()
    assert after["launches"] == before["launches"]          # the twin
    assert after["pairs"] - before["pairs"] == 6 + 9 + 9
    assert after["matches"] - before["matches"] == out.shape[0] == 24


# ------------------------------------------------------------- 1-to-1

def test_one_to_one_keeps_the_padded_rule(collection):
    """The records of a ragged batch, shuffled, through `_one_to_one`
    against `_candidate_matches` on each query's padded candidates."""
    cfg, inputs, idx = collection
    images = [0, 1, 5, 9, 30]
    rows, counts, _, _ = _batch(inputs, images)
    words, sigs = idx._encode(rows)
    f_query = torch.repeat_interleave(torch.arange(len(images)),
                                      torch.as_tensor(counts)).int()
    norm = idx._score_flat(words, sigs, f_query, len(images))
    c = 6
    _, cand = tv.top_k_largest(norm, c)
    table = torch.full((len(images), idx.n_images), -1, dtype=torch.int32)
    table.scatter_(1, cand, torch.arange(len(images) * c,
                                         dtype=torch.int32).reshape(-1, c))
    rec = VM.vocab_match(words.int(), sigs, f_query, idx._csr_off,
                         idx._csr_img, idx._csr_sig, idx._csr_feat, table,
                         tv.HE_MAX_DIST)
    rec = rec[torch.randperm(rec.shape[0],
                             generator=torch.Generator().manual_seed(0))]
    pair, qf, dbf = tv._one_to_one(rec, words.shape[0],
                                   idx._frames.shape[0])
    starts = np.concatenate([[0], np.cumsum(inputs["counts"])])
    qstart = np.concatenate([[0], np.cumsum(counts)])
    kept = 0
    for j in range(len(images)):
        a, b = qstart[j], qstart[j + 1]
        best_j, keep = tv._candidate_matches(
            words[a:b], sigs[a:b], torch.ones(b - a, dtype=torch.bool),
            idx._e_words[cand[j]], idx._e_sigs[cand[j]],
            idx._e_valid[cand[j]], idx._idf)
        for s in range(c):
            want = sorted((int(k) + a, int(best_j[s, k])
                           + int(starts[cand[j, s]]))
                          for k in torch.nonzero(keep[s])[:, 0])
            m = pair == j * c + s
            got = sorted(zip(qf[m].tolist(), dbf[m].tolist()))
            assert got == want, (j, s)
            kept += len(want)
    assert kept > 100
    # kept matches come in (pair, query feature) order
    key = pair * words.shape[0] + qf
    assert bool((key[1:] > key[:-1]).all())


# ---------------------------------------------------------- vote_and_verify

def _sets(seed, p=24, n=160):
    """p match sets of n padded matches: each a similarity-consistent
    group of at least 8 (noise 1.5 px) among outliers, some matches
    invalid; set 0 has none valid."""
    g = torch.Generator().manual_seed(seed)
    f1 = torch.zeros(p, n, 4)
    f1[..., 0] = torch.rand(p, n, generator=g) * 1000
    f1[..., 1] = torch.rand(p, n, generator=g) * 700
    f1[..., 2] = 1.5 * 16 ** torch.rand(p, n, generator=g)
    f1[..., 3] = (torch.rand(p, n, generator=g) - 0.5) * 6.28
    s = 2 ** (torch.rand(p, 1, generator=g) - 0.5)
    th = (torch.rand(p, 1, generator=g) - 0.5) * 0.7
    c, sn = torch.cos(th), torch.sin(th)
    f2 = f1.clone()
    f2[..., 0] = (s * (c * f1[..., 0] - sn * f1[..., 1]) + 40
                  + 1.5 * torch.randn(p, n, generator=g))
    f2[..., 1] = (s * (sn * f1[..., 0] + c * f1[..., 1]) - 30
                  + 1.5 * torch.randn(p, n, generator=g))
    f2[..., 2] = f1[..., 2] * s * (1 + 0.05 * torch.randn(p, n, generator=g))
    f2[..., 3] = f1[..., 3] + th + 0.08 * torch.randn(p, n, generator=g)
    share = torch.rand(p, 1, generator=g) * 0.7
    out = (torch.rand(p, n, generator=g) < share)
    out[:, :8] = False
    f2[..., 0] = torch.where(out, torch.rand(p, n, generator=g) * 1000,
                             f2[..., 0])
    f2[..., 1] = torch.where(out, torch.rand(p, n, generator=g) * 700,
                             f2[..., 1])
    valid = torch.rand(p, n, generator=g) < 0.8
    valid[:, :8] = True
    valid[0] = False
    return f1, f2, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmented_vote_equals_padded_set_by_set(seed):
    f1, f2, valid = _sets(seed)
    want = vote_and_verify(f1, f2, valid)
    p = f1.shape[0]
    seg = torch.arange(p)[:, None].expand(valid.shape)[valid]
    perm = torch.randperm(seg.shape[0],
                          generator=torch.Generator().manual_seed(seed))
    got = vote_and_verify_segmented(f1[valid][perm], f2[valid][perm],
                                    seg[perm], p)
    assert torch.equal(got.score, want.score)
    assert torch.equal(got.n_inliers, want.n_inliers)
    assert torch.equal(got.inliers, want.inliers[valid][perm])
    assert float(got.score[0]) == 0.0 and float(got.score[1:].min()) >= 3
    # the padded form's float32 normal equations of points ~1,000 px from
    # the origin hold its translation to a few hundredths of a pixel
    torch.testing.assert_close(got.model[1:], want.model[1:], rtol=1e-3,
                               atol=0.05)


def test_segmented_vote_of_one_or_two_matches():
    """Sets whose every bin holds one or two matches: the regularised
    model carries at most those matches."""
    f1, f2, _ = _sets(5, p=6, n=2)
    seg = torch.arange(6).repeat_interleave(2)[:-1]        # the last: one
    got = vote_and_verify_segmented(f1.reshape(-1, 4)[:-1],
                                    f2.reshape(-1, 4)[:-1], seg, 6)
    assert bool((got.score <= torch.tensor([2, 2, 2, 2, 2, 1])).all())
    assert bool(torch.isfinite(got.model).all())


# -------------------------------------------------------------- query_batch

def _padded(inputs, images):
    d, c, g, _ = _batch(inputs, images)
    kq = int(c.max())
    dim = d.shape[1]
    pd = torch.zeros((len(images), kq, dim), dtype=torch.uint8)
    pv = torch.zeros((len(images), kq), dtype=torch.bool)
    pg = torch.zeros((len(images), kq, 4))
    a = 0
    for j, n in enumerate(c.tolist()):
        pd[j, :n], pv[j, :n], pg[j, :n] = d[a:a + n], True, g[a:a + n]
        a += n
    return pd, pv, pg


def test_ragged_verified_query_equals_padded(collection):
    cfg, inputs, idx = collection
    images = [0, 3, 7, 12, 21, 31]
    verify, k = 8, 10
    rows, counts, frames, _ = _batch(inputs, images)
    ids, sc, _ = idx.query_batch(rows, counts=counts, geometries=frames,
                                 verify=verify, topk=k)
    pd, pv, pg = _padded(inputs, images)
    pids, psc, _ = idx.query_batch(pd, valid=pv, geometries=pg,
                                   verify=verify, topk=k, verify_chunk=2)
    # the unverified scores of both forms, equal
    base, bsc, _ = idx.query_batch(rows, counts=counts, topk=idx.n_images)
    pbase, pbsc, _ = idx.query_batch(pd, valid=pv, topk=idx.n_images)
    np.testing.assert_array_equal(base, pbase)
    np.testing.assert_array_equal(bsc, pbsc)
    unver = np.zeros((len(images), idx.n_images), np.float32)
    np.put_along_axis(unver, base, bsc, 1)
    eff = sc - np.take_along_axis(unver, ids, 1)
    peff = psc - np.take_along_axis(unver, pids, 1)
    # verification parts: the same where a fit is determined; within 2
    # inliers where the padded form's is float32 rounding noise
    got = dict(((j, i), e) for j in range(len(images))
               for i, e in zip(ids[j], eff[j]))
    want = dict(((j, i), e) for j in range(len(images))
                for i, e in zip(pids[j], peff[j]))
    common = set(got) & set(want)
    assert len(common) >= len(images) * (k - 1)
    for key in common:
        e1, e2 = got[key], want[key]
        if max(e1, e2) > 2.5:
            assert abs(e1 - e2) < 1e-3, key
        else:
            assert abs(e1 - e2) <= 2.0 + 1e-3, key
    # the query itself and its group, verified first, in both forms
    assert ids[:, 0].tolist() == images == pids[:, 0].tolist()
    # ids equal wherever the padded form's scores stand more than 2 apart
    for j in range(len(images)):
        gaps = np.abs(np.diff(psc[j]))
        for r in range(k):
            sep = min(gaps[r - 1] if r else np.inf,
                      gaps[r] if r < k - 1 else np.inf)
            if sep > 2.0 + 1e-3:
                assert ids[j, r] == pids[j, r], (j, r)


def test_ragged_verify_needs_frames(collection):
    cfg, inputs, idx = collection
    rows, counts, frames, _ = _batch(inputs, [0, 1])
    with pytest.raises(ValueError, match="geometries"):
        idx.query_batch(rows, counts=counts, verify=4)
    plain = VocabHEIndex(n_words=idx.n_words, dim=idx.dim,
                         hierarchical=True, probes=idx.probes, device="cpu")
    plain.coarse, plain.fine, plain.words = idx.coarse, idx.fine, idx.words
    plain.he_proj, plain.he_thresh = idx.he_proj, idx.he_thresh
    plain.add_images(inputs["descriptors"], inputs["counts"])
    plain.prepare()
    assert plain._csr_feat is None and plain._frames is None
    with pytest.raises(ValueError, match="built with frames"):
        plain.query_batch(rows, counts=counts, geometries=frames, verify=4)


# ------------------------------------------------------------- reference

def test_reference_against_the_port(collection):
    """The float64 reference's verified scores against the port's ragged
    verified query on the same images: ids equal where the reference's
    neighbouring scores stand apart, the normalised parts within 1e-5 of
    the first score (float32 terms against float64), the effective inlier
    counts equal on all but a hundredth of the pairs (float32 frames and
    votes against float64 can carry a match across an inlier threshold or
    a bin's edge) and within 2 there."""
    cfg, inputs, idx = collection
    ref = ref_sv.VerifiedRef(ref_vocab.VocabRef(
        inputs["descriptors"], inputs["counts"], inputs["coarse"],
        inputs["fine"], inputs["he_proj"], inputs["he_thresh"],
        cfg["tree"]["probes"], cfg["he"]["max_dist"], cfg["he"]["sigma"]),
        inputs["frames"], 8, cfg["image_extent"])
    images = list(range(0, 32, 3))
    rows, counts, frames, _ = _batch(inputs, images)
    ids, sc, _ = idx.query_batch(rows, counts=counts, geometries=frames,
                                 verify=8, topk=8)
    ids = torch.as_tensor(ids)
    ver, got = ref.verified(torch.tensor(images), ids)
    best, _ = ref.base.best(ver, 8)
    first = best[:, :1]
    err = (torch.as_tensor(sc).double() - got).abs()
    assert float((err / first).median()) < 1e-5
    assert int((err > 0.5).sum()) <= err.numel() // 100
    assert float(err.max()) <= 2.0 + 1e-3
    np.testing.assert_allclose(got.numpy(), best.numpy(), rtol=0,
                               atol=2.0 + 1e-3)
    assert ids[:, 0].tolist() == images
