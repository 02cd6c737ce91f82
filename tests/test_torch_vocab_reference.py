"""The port's vocabulary tree with Hamming embedding
(cvt_tpu_torch/index/vocab_he.py) at the size of a test, on the CPU:
against the benchmark's plain float64 reference
(benchmark/reference/vocab.py), and its large-collection paths against
the forms they replace.

Bitwise comparisons run on inputs whose float32 arithmetic is exact
(integer descriptors, fine words and projection entries, half-integer
thresholds), so any difference is a fault and not rounding:
  * the descent grouped by cell against the per-point gathered form,
    ties included;
  * `add_images` against the same `add_image` calls;
  * a ragged `query_batch` against the padded one.
Tolerances elsewhere, each for its reason:
  * the CSR twin against the bucket pass `_score_query_many`: the same
    float32 terms but exp's table made on a short tensor, whose last
    lanes take the scalar exp and may round an ulp apart, and float64
    sums in other orders: rtol 2e-7;
  * the group self-similarity against `_self_similarity`: float64 against
    float32 sums: rtol 1e-5;
  * the index against the float64 reference: the port's float32 terms,
    projection and normalisation: scores rtol 1e-5, ids equal where the
    reference's scores of neighbouring ranks lie further apart.
"""

import importlib

import numpy as np
import pytest
import torch

from benchmark.reference import vocab as ref_vocab
from cvt_tpu_torch.index import VocabHEIndex
from cvt_tpu_torch.index import vocab_he as tv
from cvt_tpu_torch.ops.kernels import vocab_score as V

K = importlib.import_module("cvt_tpu_torch.ops.kmeans")


def _collection(seed: int, n_images: int = 32, dim: int = 128,
                k1: int = 8, k2: int = 8, exact: bool = False):
    """A small collection in groups of 4 images sharing noisy copies of
    rows, a two-level tree whose words are collection-like rows, and the
    Hamming embedding's projection and thresholds. With `exact`, the
    projection holds -1/0/1 and the thresholds half-integers."""
    rng = np.random.default_rng(seed)
    centres = rng.gamma(1.2, 24.0, (64, dim))
    counts = rng.integers(24, 90, n_images)
    scene = np.clip(centres[rng.integers(0, 64, (n_images // 4 + 1, 200))]
                    + rng.normal(0, 12, (n_images // 4 + 1, 200, dim)),
                    0, 255)
    rows = []
    for i, c in enumerate(counts):
        own = np.clip(centres[rng.integers(0, 64, c)]
                      + rng.normal(0, 12, (c, dim)), 0, 255)
        shared = scene[i // 4][rng.integers(0, 200, c)] + rng.normal(
            0, 3, (c, dim))
        take = rng.random(c) < 0.5
        rows.append(np.where(take[:, None], shared, own))
    rows = np.clip(np.round(np.concatenate(rows)), 0, 255).astype(np.uint8)
    fine = np.round(np.clip(centres[rng.integers(0, 64, (k1, k2))]
                            + rng.normal(0, 12, (k1, k2, dim)), 0, 255))
    coarse = fine.mean(1)
    if exact:
        coarse = np.round(coarse)
        proj = rng.integers(-1, 2, (dim, 64)).astype(np.float64)
    else:
        proj = np.linalg.qr(rng.normal(size=(dim, dim)))[0][:, :64]
    p = rows.astype(np.float64) @ proj
    thr = np.tile(np.median(p, 0), (k1 * k2, 1)) + rng.normal(
        0, 2.0, (k1 * k2, 64))
    if exact:
        thr = np.floor(thr) + 0.5
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return rows, counts, f32(coarse), f32(fine), f32(proj), f32(thr)


def _index(coarse, fine, proj, thr, probes=4, **kw):
    k1, k2, d = fine.shape
    idx = VocabHEIndex(n_words=k1 * k2, dim=d, hierarchical=True,
                       probes=probes, device="cpu", **kw)
    idx.coarse, idx.fine = coarse, fine
    idx.words = fine.reshape(-1, d)
    idx.he_proj, idx.he_thresh = proj, thr
    return idx


@pytest.fixture(scope="module")
def exact():
    rows, counts, coarse, fine, proj, thr = _collection(1, exact=True)
    idx = _index(coarse, fine, proj, thr, bucket_cap=8)
    idx.add_images(rows, counts)
    idx.prepare()
    return rows, counts, idx


@pytest.mark.parametrize("probes", [1, 3, 8])
def test_grouped_descent_equals_the_gathered_form_with_ties(probes):
    g = torch.Generator().manual_seed(probes)
    x = torch.randint(0, 4, (3000, 16), generator=g).float()
    coarse = torch.randint(0, 4, (8, 16), generator=g).float()
    fine = torch.randint(0, 4, (8, 8, 16), generator=g).float()
    fine[3, 5] = fine[3, 2]                 # the same word twice in a cell
    fine[6, 1] = fine[2, 7]                 # and in two cells
    coarse[4] = coarse[1]                   # two cells at one distance
    want = K._hier_assign_gathered(x, coarse, fine, probes)
    got = K._hier_assign_chunk(x, coarse, fine, probes)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # in chunks, through the public entry point
    w, d = K.hierarchical_assign(x, coarse, fine, probes=probes, chunk=700,
                                 device="cpu")
    assert torch.equal(w, want[0]) and torch.equal(d, want[1])


def test_grouped_descent_on_collection_rows():
    rows, _, coarse, fine, _, _ = _collection(2)
    x = torch.from_numpy(rows).float()
    want = K._hier_assign_gathered(x, coarse, fine, 4)
    got = K._hier_assign_chunk(x, coarse, fine, 4)
    # integer rows and words: every product exact, so bitwise
    assert torch.equal(got[0], want[0])


def test_add_images_equals_add_image_calls(exact):
    rows, counts, idx = exact
    *_, coarse, fine, proj, thr = _collection(1, exact=True)
    one = _index(coarse, fine, proj, thr, bucket_cap=8)
    ends = np.cumsum(counts)
    for a, b in zip(ends - counts, ends):
        one.add_image(rows[a:b].astype(np.float32))
    one.prepare()
    assert one._names == idx._names
    for (i1, w1, s1, g1), (i2, w2, s2, g2) in zip(one._entries,
                                                  idx._entries):
        assert i1 == i2
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(g1, g2)
    for name in ("_b_img", "_b_sig", "_b_burst", "_t_word", "_t_img",
                 "_t_sig", "_t_burst", "_e_words", "_e_sigs", "_e_valid",
                 "_idf", "_self_norm", "_csr_off", "_csr_img", "_csr_sig",
                 "_csr_burst"):
        assert torch.equal(getattr(one, name), getattr(idx, name)), name


def test_ragged_query_batch_equals_padded(exact):
    rows, counts, idx = exact
    q = [3, 9, 10, 31]
    ends = np.cumsum(counts)
    parts = [rows[ends[i] - counts[i]:ends[i]] for i in q]
    kq = max(len(p) for p in parts)
    padded = np.zeros((len(q), kq, rows.shape[1]), np.float32)
    valid = np.zeros((len(q), kq), bool)
    for j, p in enumerate(parts):
        padded[j, :len(p)] = p
        valid[j, :len(p)] = True
    ids_p, sc_p, _ = idx.query_batch(padded, valid=valid, topk=7)
    ids_r, sc_r, _ = idx.query_batch(np.concatenate(parts),
                                     counts=[len(p) for p in parts], topk=7)
    np.testing.assert_array_equal(ids_r, ids_p)
    np.testing.assert_array_equal(sc_r, sc_p)
    assert list(ids_r[:, 0]) == q
    # float32 rows are staged as they are: the same answers
    ids_f, sc_f, _ = idx.query_batch(np.concatenate(parts).astype(
        np.float32), counts=[len(p) for p in parts], topk=7)
    np.testing.assert_array_equal(ids_f, ids_r)
    np.testing.assert_array_equal(sc_f, sc_r)


def test_csr_twin_against_the_bucket_pass(exact):
    rows, counts, idx = exact
    assert idx.n_overflow > 0               # the tail holds entries too
    words, sigs = idx._encode(rows[:400].astype(np.float32))
    words, sigs = words.reshape(4, 100), sigs.reshape(4, 100)
    valid = torch.ones((4, 100), dtype=torch.bool)
    valid[2, 60:] = False
    want = tv._score_query_many(words, sigs, valid, *idx._layout(),
                                idx.n_images)
    got = V.vocab_score_plain(
        torch.where(valid, words, -1).reshape(-1), sigs.reshape(-1),
        torch.arange(4, dtype=torch.int32).repeat_interleave(100),
        *idx._csr(), 4, idx.n_images)
    torch.testing.assert_close(got, want, rtol=2e-7, atol=0)
    assert float(got.sum()) > 0


def test_csr_layout_of_a_loaded_index(exact, tmp_path):
    _, _, idx = exact
    path = str(tmp_path / "v.npz")
    idx.save(path)
    back = VocabHEIndex.load(path, device="cpu")
    for name in ("_csr_off", "_csr_img", "_csr_sig", "_csr_burst", "_wtab"):
        assert torch.equal(getattr(back, name), getattr(idx, name)), name
    off = idx._csr_off
    assert int(off[-1]) == int((idx._b_img >= 0).sum()) + idx.n_overflow


def test_group_self_similarity_against_the_pair_mask(exact):
    _, _, idx = exact
    sw = torch.where(idx._e_valid, idx._e_words, 0)
    want = tv._self_similarity(sw, idx._e_sigs, idx._e_valid, idx._idf)
    torch.testing.assert_close(idx._self_norm ** 2, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("seed", [3, 4])
def test_index_against_the_float64_reference(seed):
    rows, counts, coarse, fine, proj, thr = _collection(seed)
    idx = _index(coarse, fine, proj, thr)
    idx.add_images(rows, counts)
    idx.prepare()
    ref = ref_vocab.VocabRef(torch.from_numpy(rows), counts, coarse, fine,
                             proj, thr, 4, tv.HE_MAX_DIST, tv.HE_SIGMA)
    # the descent and the signatures: the same words; bits apart only
    # where a projection lies within float32 rounding of its threshold
    w = np.concatenate([e[1] for e in idx._entries])
    np.testing.assert_array_equal(w, ref.words.numpy())
    s = np.concatenate([e[2] for e in idx._entries])
    assert int((s != ref.sigs.numpy()).sum()) <= len(s) // 1000
    k = 10
    ids, sc, _ = idx.query_batch(rows, counts=counts, topk=k)
    best, best_i = ref.best(ref.scores(torch.arange(len(counts))), k)
    np.testing.assert_allclose(sc, best.numpy(), rtol=1e-5)
    got = torch.gather(ref.scores(torch.arange(len(counts))), 1,
                       torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), best.numpy(), rtol=1e-5)
    differ = ids != best_i.numpy()
    gaps = np.abs(np.diff(best.numpy(), axis=1))
    near = np.zeros_like(differ)
    near[:, :-1] |= gaps < 1e-5 * best.numpy()[:, :-1]
    near[:, 1:] |= gaps < 1e-5 * best.numpy()[:, 1:]
    assert not (differ & ~near).any()
    assert list(ids[:, 0]) == list(range(len(counts)))
