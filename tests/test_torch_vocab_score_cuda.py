"""`vocab_score_kernel` (csrc/vocab_score.cu) on the card against its
plain twin `vocab_score_plain` (ops/kernels/vocab_score.py).

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_vocab_score_cuda.py --noconftest -m cuda

Tolerance: the kernel and the twin (run on the card, so that both take
the same float32 terms from the same table) sum the same terms in
float64 in different orders, so each float32 score is the twin's or a
rounding apart at a boundary: |kernel - twin| <= 2^-23 |twin|.
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.ops.kernels import vocab_score as V

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _wtab(dev, max_dist=24, sigma=16.0):
    h = torch.arange(max_dist + 1, device=dev, dtype=torch.float32)
    return torch.exp(-(h ** 2) / (sigma * sigma))


def _lists(lengths, n_images, dev, gen):
    """A CSR inverted file with these list lengths, random images,
    signatures and burstiness."""
    lengths = torch.as_tensor(lengths, dtype=torch.int64)
    off = torch.zeros(len(lengths) + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(lengths, 0)
    e = int(off[-1])
    img = torch.randint(0, n_images, (e,), generator=gen, dtype=torch.int32)
    sig = torch.randint(-2 ** 63, 2 ** 63 - 1, (e,), generator=gen,
                        dtype=torch.int64)
    burst = 1.0 / torch.randint(1, 5, (e,), generator=gen).float().sqrt()
    idf = torch.rand(len(lengths), generator=gen) * 8.0
    return [t.to(dev) for t in (off, img, sig, burst, idf)]


def _near(sig, gen, bits):
    """Signatures within a few bits of `sig`, so that many pairs score."""
    out = sig.clone()
    for _ in range(bits):
        b = torch.randint(0, 64, sig.shape, generator=gen)
        flip = torch.where(b == 63, torch.tensor(-2 ** 63),
                           torch.tensor(1) << b.clamp_max(62))
        out = out ^ flip
    return out


def _check(args):
    got = V.vocab_score(*args)
    want = V.vocab_score_plain(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = (got.double() - want.double()).abs()
    assert bool((err <= 2.0 ** -23 * want.double().abs()).all()), \
        float(err.max())
    return got, want


def _features(off, sig_e, n_words, q, per, dev, gen, near_share=0.5):
    """q queries of `per` features each: random words, half of the
    signatures near an entry of the word's list."""
    w = torch.randint(0, n_words, (q * per,), generator=gen)
    offc = off.cpu()
    f_sig = torch.randint(-2 ** 63, 2 ** 63 - 1, (q * per,), generator=gen,
                          dtype=torch.int64)
    length = offc[w + 1] - offc[w]
    has = length > 0
    pick = offc[w] + (torch.rand(q * per, generator=gen) * length).long()
    src = sig_e.cpu()[pick.clamp_max(max(len(sig_e) - 1, 0))]
    near = has & (torch.rand(q * per, generator=gen) < near_share)
    f_sig = torch.where(near, _near(src, gen, 6), f_sig)
    f_query = torch.arange(q).repeat_interleave(per).to(torch.int32)
    return [t.to(dev) for t in (w.to(torch.int32), f_sig, f_query)]


def test_at_the_cells_shapes(card):
    """1,048,576 words holding ~16.3M entries with skewed list lengths,
    5,062 images, 64 queries of ~3,227 features."""
    gen = torch.Generator().manual_seed(3)
    n_words, n_images, q, per = 1 << 20, 5062, 64, 3227
    lengths = torch.distributions.Pareto(torch.tensor(4.0), torch.tensor(
        1.6)).sample((n_words,)).floor().long().clamp_max(20_000)
    off, img, sig, burst, idf = _lists(lengths, n_images, card, gen)
    f_word, f_sig, f_query = _features(off, sig, n_words, q, per, card, gen)
    args = (f_word, f_sig, f_query, off, img, sig, burst, idf, _wtab(card),
            q, n_images)
    got, _ = _check(args)
    assert int((got > 0).sum()) > q * 100
    # the same scores on every call: float64 sums rounded once
    for _ in range(3):
        assert torch.equal(V.vocab_score(*args), got)


def test_a_list_longer_than_a_block_and_empty_lists(card):
    """One list of 100,003 entries (many blocks' worth of threads), lists
    of 0 entries, and features with no word (-1)."""
    gen = torch.Generator().manual_seed(4)
    lengths = [0, 100_003, 0, 5, 0, 0, 1, 300]
    off, img, sig, burst, idf = _lists(lengths, 97, card, gen)
    w = torch.tensor([1, 0, 2, -1, 1, 3, 4, 7, -1, 6, 1], dtype=torch.int32)
    f_query = torch.tensor([0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3],
                           dtype=torch.int32)
    f_sig = sig.cpu()[off.cpu()[w.clamp_min(0).long()].clamp_max(
        len(sig) - 1)]
    f_sig = _near(f_sig, gen, 3)
    args = (w.to(card), f_sig.to(card), f_query.to(card), off, img, sig,
            burst, idf, _wtab(card), 4, 97)
    got, _ = _check(args)
    assert float(got[0].sum()) > 0
    # every feature without a list: all zeros
    none = (torch.tensor([0, 2, -1], dtype=torch.int32).to(card),
            f_sig[:3].to(card), torch.zeros(3, dtype=torch.int32,
                                            device=card))
    zero = V.vocab_score(*none, off, img, sig, burst, idf, _wtab(card), 2,
                         97)
    assert not bool(zero.any())


def test_repeated_words_in_one_query(card):
    """Every feature of a query holds the same word: its list is walked
    once a feature, and the image's score is the sum over them."""
    gen = torch.Generator().manual_seed(5)
    off, img, sig, burst, idf = _lists([40, 2_000, 7], 13, card, gen)
    w = torch.tensor([1] * 50 + [2] * 3 + [1] * 4, dtype=torch.int32)
    f_query = torch.tensor([0] * 53 + [1] * 4, dtype=torch.int32)
    f_sig = _near(sig.cpu()[off.cpu()[w.long()]], gen, 2)
    args = (w.to(card), f_sig.to(card), f_query.to(card), off, img, sig,
            burst, idf, _wtab(card), 2, 13)
    _check(args)


@pytest.mark.parametrize("h,scores", [(24, True), (25, False)])
def test_hamming_at_the_limit(card, h, scores):
    """An entry exactly 24 bits away scores exp(-24^2/16^2) * idf^2 *
    burst; one 25 bits away scores nothing."""
    sig = torch.tensor([0x0123_4567_89AB_CDEF], dtype=torch.int64)
    mask = torch.tensor([(1 << h) - 1], dtype=torch.int64)
    e_sig = (sig ^ mask).to(card)
    off = torch.tensor([0, 1], dtype=torch.int64, device=card)
    img = torch.tensor([2], dtype=torch.int32, device=card)
    burst = torch.tensor([0.5], device=card)
    idf = torch.tensor([3.0], device=card)
    wtab = _wtab(card)
    got = V.vocab_score(torch.zeros(1, dtype=torch.int32, device=card),
                        sig.to(card), torch.zeros(1, dtype=torch.int32,
                                                  device=card),
                        off, img, e_sig, burst, idf, wtab, 1, 4)
    want = float(wtab[24] * 9.0 * 0.5) if scores else 0.0
    assert float(got[0, 2]) == pytest.approx(want, rel=1e-7, abs=0)
    assert float(got[0, [0, 1, 3]].abs().sum()) == 0.0


def test_twin_check_on_an_index_query(card):
    """The arguments a card index's ragged query_batch hands the wrapper,
    through `twin_check` (the twin on the CPU)."""
    from cvt_tpu_torch.index import VocabHEIndex
    from cvt_tpu_torch.ops import kernels
    rng = np.random.default_rng(6)
    train = rng.gamma(1.5, 20.0, (4096, 128)).astype(np.float32)
    idx = VocabHEIndex(n_words=256, hierarchical=True, probes=4,
                       device=card)
    idx.train(torch.Generator().manual_seed(0), train, iters=6)
    counts = rng.integers(20, 120, 40)
    rows = np.clip(train[rng.integers(0, 4096, counts.sum())]
                   + rng.normal(0, 3, (counts.sum(), 128)), 0, 255).astype(
        np.uint8)
    idx.add_images(rows, counts)
    idx.prepare()
    args = kernels.recorded_args("vocab_score", lambda: idx.query_batch(
        rows[:counts[:8].sum()], counts=counts[:8], topk=5))
    got = kernels.twin_check("vocab_score", args)
    assert got["shape"] == [8, 40]
