"""The vocabulary tree's image scores are float64 sums rounded once to
float32, so their value does not depend on the order in which the terms
are added (on the card: the order in which `index_add_`'s atomics land).

`_score_query_many` is held bitwise against a numpy sum of the same
float32 terms, accumulated in float64 in a shuffled order and rounded
once. Needs no JAX.
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.index import VocabHEIndex
from cvt_tpu_torch.index import vocab_he as tv


def _index(bucket_cap):
    rng = np.random.default_rng(3)
    train = rng.gamma(1.5, 20.0, size=(4096, 128)).astype(np.float32)
    idx = VocabHEIndex(n_words=64, bucket_cap=bucket_cap, hierarchical=False,
                       device="cpu")
    idx.train(torch.Generator().manual_seed(0), train, iters=4)
    for i in range(40):
        d = np.clip(train[rng.integers(0, 4096, 96)]
                    + rng.normal(0, 3.0, (96, 128)), 0, 255)
        idx.add_image(d.astype(np.float32), name=f"im{i}")
    idx.prepare()
    q = np.clip(train[rng.integers(0, 4096, (5, 80))]
                + rng.normal(0, 3.0, (5, 80, 128)), 0, 255)
    words, sigs = idx._encode(q.reshape(-1, 128).astype(np.float32))
    valid = torch.from_numpy(rng.random((5, 80)) > 0.1)
    return idx, words.reshape(5, 80), sigs.reshape(5, 80), valid


def _popcount(x: np.ndarray) -> np.ndarray:
    return np.unpackbits(x[..., None].view(np.uint8), axis=-1).sum(-1)


def _terms(idx, words, sigs, valid):
    """Every (query, image, float32 term) the scoring pass adds, from the
    layout's arrays: bucket entries of each query word, then the overflow
    tail's entries of the same word."""
    w, s, v = words.numpy(), sigs.numpy(), valid.numpy()
    b_img, b_sig, b_burst, t_word, t_img, t_sig, t_burst, idf = (
        a.numpy() for a in idx._layout())
    weight = tv._he_weight(torch.arange(65)).numpy()        # by distance
    qs, imgs, terms = [], [], []
    for qi, j in zip(*np.nonzero(v)):
        wj = w[qi, j]
        entries = [(b_img[wj], b_sig[wj], b_burst[wj])]
        tail = (t_word == wj) & (t_img >= 0)
        entries.append((t_img[tail], t_sig[tail], t_burst[tail]))
        for img, sig, burst in entries:
            keep = img >= 0
            h = _popcount(np.bitwise_xor(sig[keep], s[qi, j]))
            # the pass's float32 products, in its order
            t = weight[h] * np.float32(idf[wj] ** 2) * burst[keep]
            qs.append(np.full(keep.sum(), qi))
            imgs.append(img[keep])
            terms.append(t.astype(np.float32))
    return np.concatenate(qs), np.concatenate(imgs), np.concatenate(terms)


@pytest.mark.parametrize("bucket_cap", [None, 8])
def test_scores_are_float64_sums_rounded_once(bucket_cap):
    idx, words, sigs, valid = _index(bucket_cap)
    if bucket_cap is not None:
        assert idx.n_overflow > 0          # the tail pass has work
    got = tv._score_query_many(words, sigs, valid, *idx._layout(),
                               idx.n_images, tail_tc=7)
    assert got.dtype == torch.float32
    q, img, t = _terms(idx, words, sigs, valid)
    order = np.random.default_rng(0).permutation(len(t))   # any order
    flat = q[order] * idx.n_images + img[order]
    want = np.bincount(flat, weights=t[order].astype(np.float64),
                       minlength=words.shape[0] * idx.n_images)
    want = want.astype(np.float32).reshape(words.shape[0], idx.n_images)
    np.testing.assert_array_equal(got.numpy(), want)
    # the single-query pass is the same sum
    one = tv._score_one(words[2], sigs[2], valid[2], *idx._layout(),
                        idx.n_images)
    np.testing.assert_array_equal(one.numpy(), want[2])
