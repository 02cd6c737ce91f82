"""The port's vocabulary tree + Hamming embedding index
(cvt_tpu_torch/index/vocab_he.py) held against cvt_tpu.index.VocabHEIndex
on the same numpy inputs, on the CPU.

A cvt_tpu-trained vocabulary (flat, or hierarchical at probes 4 and 0) is
carried across with convert.vocab_he_from_numpy, so both packages assign
the same words from the same arrays. Tolerances: word ids, signatures
(as cvt_tpu's uint32 pairs) and every integer array of the prepared
layout bitwise; idf and burstiness bitwise (the same host numpy code);
self-similarity norms and scores rtol 1e-5 (float32 sums in another
order); names equal. Verified queries use geometry-consistent images, so
that every verified candidate's best seed holds >= 3 votes (a seed fitted
from 1-2 matches is a near-singular solve whose float32 result depends on
rounding in either package)."""

import jax
import numpy as np
import pytest
import torch

from cvt_tpu.index import VocabHEIndex as JIndex
from cvt_tpu_torch.convert import vocab_he_from_numpy
from cvt_tpu_torch.index import VocabHEIndex
from cvt_tpu_torch.index import vocab_he as tv

LAYOUT = ("b_img", "b_burst", "t_word", "t_img", "t_burst", "e_words",
          "e_geom", "e_valid", "idf")
SIGS = ("b_sig", "t_sig", "e_sigs")
VOCAB = ("words", "coarse", "fine", "he_proj", "he_thresh")


def _images(seed: int, n: int, k: int = 48):
    rng = np.random.default_rng(seed)
    train = rng.gamma(1.5, 20.0, size=(4096, 128)).astype(np.float32)
    images = [np.clip(train[rng.integers(0, 4096, k)]
                      + rng.normal(0, 2.0, (k, 128)), 0, 255)
              .astype(np.float32) for _ in range(n)]
    geoms = rng.uniform(0, 512, (n, k, 4)).astype(np.float32)
    return train, images, geoms


def _vocab_arrays(j: JIndex) -> dict:
    hier = j.coarse is not None
    return {"words": np.array(j.words),
            "coarse": (np.array(j.coarse) if hier
                       else np.zeros((0, j.dim), np.float32)),
            "fine": (np.array(j.fine) if hier
                     else np.zeros((0, 0, j.dim), np.float32)),
            "he_proj": np.array(j.he_proj),
            "he_thresh": np.array(j.he_thresh)}


@pytest.fixture(scope="module", params=["flat", "hier4", "exact"])
def vocab(request):
    """A cvt_tpu-trained vocabulary and the port's copy of it."""
    train, images, geoms = _images(0, 12)
    kw = {"flat": dict(n_words=256),
          "hier4": dict(n_words=256, hierarchical=True, probes=4),
          "exact": dict(n_words=256, hierarchical=True, probes=0)}
    j = JIndex(**kw[request.param])
    j.train(jax.random.key(0), train, iters=8)
    t = vocab_he_from_numpy(_vocab_arrays(j), device="cpu")
    t.probes = j.probes
    assert t.hierarchical == j.hierarchical and t.n_images == 0
    return j, t, images, geoms


def test_popcount_matches_numpy(rng):
    x = rng.integers(-2 ** 63, 2 ** 63 - 1, size=4000, dtype=np.int64)
    x[:4] = [-1, -2 ** 63, 0, 2 ** 63 - 1]        # top bit set and clear
    want = np.unpackbits(x.view(np.uint8)).reshape(-1, 64).sum(-1)
    got = tv._popcount(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    a, b = x[:2000], x[2000:]
    np.testing.assert_array_equal(
        tv._hamming(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.unpackbits((a ^ b).view(np.uint8)).reshape(-1, 64).sum(-1))
    # pack: bit i of the word is bits[..., i]; uint32 pairs round-trip
    bits = rng.random((50, 64)) < 0.5
    bits[:, 63] = True
    packed = tv._pack_bits(torch.from_numpy(bits)).numpy()
    pairs = tv.sigs_to_u32(packed)
    want_lo = (bits[:, :32] * (1 << np.arange(32, dtype=np.uint64))).sum(-1)
    np.testing.assert_array_equal(pairs[:, 0], want_lo.astype(np.uint32))
    np.testing.assert_array_equal(tv.sigs_from_u32(pairs), packed)


def test_encode_words_and_signatures_bitwise(vocab, rng):
    j, t, images, _ = vocab
    d = rng.gamma(1.5, 20.0, size=(300, 128)).astype(np.float32)
    jw, js = j._encode(d)
    w, s = t._encode(torch.from_numpy(d))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tv.sigs_to_u32(s.numpy()), np.asarray(js))
    assert w.dtype == torch.int32 and s.dtype == torch.int64


@pytest.mark.parametrize("bucket_cap", [None, 2])
def test_prepared_layout_bitwise(vocab, bucket_cap):
    """Buckets, overflow tail, entries, idf and burstiness from the same
    images: bitwise; self-similarity norms rtol 1e-5."""
    j0, _, images, geoms = vocab
    j = JIndex(n_words=256, hierarchical=j0.hierarchical, probes=j0.probes,
               bucket_cap=bucket_cap)
    for name in VOCAB:
        setattr(j, name, getattr(j0, name))
    t = vocab_he_from_numpy(_vocab_arrays(j0), device="cpu")
    t.probes, t.bucket_cap = j0.probes, bucket_cap
    for i, d in enumerate(images):
        j.add_image(d, name=f"im{i}", geometries=geoms[i])
        t.add_image(d, name=f"im{i}", geometries=geoms[i])
    j.prepare()
    t.prepare()
    for name in LAYOUT:
        np.testing.assert_array_equal(getattr(t, "_" + name).numpy(),
                                      np.asarray(getattr(j, "_" + name)),
                                      err_msg=name)
    for name in SIGS:
        np.testing.assert_array_equal(
            tv.sigs_to_u32(getattr(t, "_" + name).numpy()),
            np.asarray(getattr(j, "_" + name)), err_msg=name)
    np.testing.assert_allclose(t._self_norm.numpy(),
                               np.asarray(j._self_norm), rtol=1e-5)
    assert t.n_overflow == j.n_overflow
    assert t.n_overflow > 0 or bucket_cap is None


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A prepared cvt_tpu index with an overflow tail (bucket_cap 2),
    saved and carried across whole."""
    train, images, geoms = _images(1, 16)
    j = JIndex(n_words=128, bucket_cap=2)
    j.train(jax.random.key(0), train, iters=8)
    for i, d in enumerate(images):
        j.add_image(d, name=f"im{i}", geometries=geoms[i])
    j.prepare()
    assert j.n_overflow > 0
    path = str(tmp_path_factory.mktemp("vocab") / "j.npz")
    j.save(path)
    with np.load(path) as z:
        t = vocab_he_from_numpy(z, device="cpu")
    return j, t, images, path


def _queries(images, rng, srcs=(1, 4, 7, 11)):
    return np.stack([np.clip(images[i] + rng.normal(0, 6, images[i].shape),
                             0, 255) for i in srcs]).astype(np.float32)


def test_query_and_query_batch_on_carried_index(carried, rng):
    j, t, images, _ = carried
    qs = _queries(images, rng)
    for qi in range(len(qs)):
        n1, s1 = j.query(qs[qi], topk=5)
        n2, s2 = t.query(qs[qi], topk=5)
        assert n2 == n1
        np.testing.assert_allclose(s2, s1, rtol=1e-5)
    valid = np.ones(qs.shape[:2], bool)
    valid[1, 30:] = False
    jid, jsc, jn = j.query_batch(qs, topk=5, valid=valid)
    tid, tsc, tn = t.query_batch(qs, topk=5, valid=valid)
    assert tn == jn
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5)
    assert [tn[i] for i in tid[:, 0]] == ["im1", "im4", "im7", "im11"]


def test_score_passes_across_tail_chunks(carried, rng):
    """The scoring pass alone against cvt_tpu's `_score_one`, with the
    overflow tail cut into chunks of 3 entries (a ragged last one)."""
    from cvt_tpu.index import vocab_he as jv
    j, t, images, _ = carried
    qs = _queries(images, rng, (2, 9))
    jw, js = j._encode(qs.reshape(-1, 128))
    words = torch.from_numpy(np.array(jw)).reshape(2, -1)
    sigs = torch.from_numpy(tv.sigs_from_u32(np.array(js))).reshape(2, -1)
    valid = torch.ones(words.shape, dtype=torch.bool)
    assert t._t_img.shape[0] % 3
    got = tv._score_query_many(words, sigs, valid, *t._layout(),
                               t.n_images, tail_tc=3)
    for qi in range(2):
        want = jv._score_one(
            np.asarray(jw).reshape(2, -1)[qi],
            np.asarray(js).reshape(2, -1, 2)[qi], np.ones(words.shape[1],
                                                          bool),
            j._b_img, j._b_sig, j._b_burst, j._t_word, j._t_img, j._t_sig,
            j._t_burst, j._idf, j.n_images, tail_tc=3)
        np.testing.assert_allclose(got[qi].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-7)
        one = tv._score_one(words[qi], sigs[qi], valid[qi], *t._layout(),
                            t.n_images, tail_tc=5)
        np.testing.assert_allclose(one.numpy(), got[qi].numpy(), rtol=1e-5,
                                   atol=1e-7)


def _geom_images(rng):
    """Two descriptor pools, each seen by two database images under two
    similarities, and a query of each pool under a third: every verified
    candidate (verify=2) matches its query consistently."""
    d_dim, k = 32, 48
    pools = [rng.normal(size=(k, d_dim)).astype(np.float32)
             for _ in range(2)]

    def view(pool, th, s, shift):
        d = pool + rng.normal(scale=0.02, size=pool.shape)
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        g = np.zeros((k, 4), np.float32)
        g[:, 0] = np.linspace(10, 400, k)
        g[:, 1] = np.linspace(300, 20, k) + rng.uniform(-30, 30, k)
        g[:, 2] = 2.0
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        g[:, :2] = g[:, :2] @ (s * rot).T + shift
        g[:, 2] *= s
        g[:, 3] = th
        return d, g
    db = [view(pools[p], th, s, sh) for p, th, s, sh in (
        (0, 0.0, 1.0, (0, 0)), (0, 0.3, 1.2, (20, -10)),
        (1, 0.0, 1.0, (5, 5)), (1, -0.2, 0.9, (-15, 30)))]
    qs = [view(pools[p], 0.1, 1.1, (12, -9)) for p in (0, 1)]
    return db, qs


def test_verified_query_on_carried_vocabulary(rng, tmp_path):
    db, qs = _geom_images(rng)
    j = JIndex(n_words=16, dim=32)
    j.train(jax.random.key(0), np.concatenate([d for d, _ in db]))
    t = vocab_he_from_numpy(_vocab_arrays(j), device="cpu")
    for i, (d, g) in enumerate(db):
        j.add_image(d, name=f"db{i}", geometries=g)
        t.add_image(d, name=f"db{i}", geometries=g)
    j.prepare()
    t.prepare()
    for d, g in qs:
        n1, s1 = j.query(d, topk=4, geometries=g, verify=2)
        n2, s2 = t.query(d, topk=4, geometries=g, verify=2)
        assert n2 == n1
        np.testing.assert_allclose(s2, s1, rtol=1e-5)
        assert s2[0] > 10.0                       # verified inliers count
    qd = np.stack([d for d, _ in qs])
    qg = np.stack([g for _, g in qs])
    jid, jsc, _ = j.query_batch(qd, topk=4, geometries=qg, verify=2)
    tid, tsc, _ = t.query_batch(qd, topk=4, geometries=qg, verify=2,
                                verify_chunk=1)
    np.testing.assert_array_equal(tid, jid)
    np.testing.assert_allclose(tsc, jsc, rtol=1e-5)
    with pytest.raises(ValueError, match="geometries"):
        t.query(qs[0][0], verify=2)


def test_save_load_both_ways(carried, rng, tmp_path):
    """The port loads cvt_tpu's file and cvt_tpu loads the port's: the
    arrays round-trip bitwise and answer the same."""
    j, t, images, path = carried
    t2 = VocabHEIndex.load(path, device="cpu")
    p2 = str(tmp_path / "t.npz")
    t2.save(p2)
    with np.load(path) as a, np.load(p2) as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_array_equal(b[name], a[name], err_msg=name)
    j2 = JIndex.load(p2)
    q = _queries(images, rng, (3,))[0]
    n1, s1 = j2.query(q, topk=5)
    n2, s2 = t2.query(q, topk=5)
    assert n2 == n1 and n1[0] == "im3"
    np.testing.assert_allclose(s2, s1, rtol=1e-5)


def test_loaded_index_refuses_add_image(carried):
    """cvt_tpu's defect, copied: a loaded index cannot take new images
    (cvt_tpu/cli.py:316 crashes on it)."""
    j, _, images, path = carried
    for idx in (JIndex.load(path), VocabHEIndex.load(path, device="cpu")):
        with pytest.raises(ValueError, match="loaded VocabHEIndex"):
            idx.add_image(images[0], name="new")


@pytest.fixture(scope="module")
def own():
    """The port's own training, tests/test_vocab_he.py's setup."""
    rng = np.random.default_rng(0)
    train = rng.gamma(1.5, 20.0, size=(4096, 128)).astype(np.float32)
    images = [np.clip(train[rng.integers(0, 4096, 64)]
                      + rng.normal(0, 2.0, (64, 128)), 0, 255)
              .astype(np.float32) for _ in range(20)]
    idx = VocabHEIndex(n_words=256, device="cpu")
    idx.train(torch.Generator().manual_seed(0), train, iters=10)
    for i, d in enumerate(images):
        idx.add_image(d, name=f"im{i}")
    idx.prepare()
    return idx, images


def test_own_train_self_and_noisy_query(own, rng):
    idx, images = own
    for i in (0, 5, 13):
        names, scores = idx.query(images[i], topk=5)
        assert names[0] == f"im{i}"
        assert scores[0] <= 1.5
    q = (images[7] + rng.normal(0, 1.0, images[7].shape)).astype(np.float32)
    names, _ = idx.query(q, topk=3)
    assert "im7" in names[:2]
    bits = np.unpackbits(tv.sigs_to_u32(idx._encode(
        images[3])[1].numpy()).view(np.uint8))
    assert 0.2 < bits.mean() < 0.8
    assert idx.he_proj.shape == (128, 64)


@pytest.mark.parametrize("probes", [4, 0])
def test_own_train_hierarchical(probes):
    rng = np.random.default_rng(3)
    train = rng.gamma(1.5, 20.0, size=(4096, 128)).astype(np.float32)
    images = [np.clip(train[rng.integers(0, 4096, 48)]
                      + rng.normal(0, 2.0, (48, 128)), 0, 255)
              .astype(np.float32) for _ in range(8)]
    idx = VocabHEIndex(n_words=256, hierarchical=True, probes=probes,
                       device="cpu")
    idx.train(torch.Generator().manual_seed(0), train, iters=8)
    assert idx.coarse.shape == (16, 128) and idx.fine.shape == (16, 16, 128)
    for i, d in enumerate(images):
        idx.add_image(d, name=f"im{i}")
    ids, _, names = idx.query_batch(np.stack([images[i] for i in (0, 3, 7)]),
                                    topk=3)
    assert [names[i] for i in ids[:, 0]] == ["im0", "im3", "im7"]
