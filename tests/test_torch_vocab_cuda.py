"""The tie-exact top-k and VocabHEIndex on the card.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_vocab_cuda.py --noconftest -m cuda

Tolerances: the top-k bitwise against the stable sort (values and ids).
VocabHEIndex on the card against the same index on the CPU: scores rtol
1e-5, ids equal except where a score lies within that of its neighbour's;
word ids and signatures equal except counted near-ties of the float32
products (at most 1 in 500). The scoring pass on the same words: card
against CPU rtol 1e-6 (float64 partial sums of terms whose float32 exp
may round apart), and the card's scores bitwise equal over 20 calls.
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.index import VocabHEIndex
from cvt_tpu_torch.ops import topk

pytestmark = pytest.mark.cuda
RTOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("kind,shape", [("f32", (8192, 65536)),
                                        ("inf", (8192, 65536)),
                                        ("int32", (8192, 7936)),
                                        ("cast", (8192, 7936)),
                                        ("bins", (1280, 16384))])
@pytest.mark.parametrize("largest", [False, True])
def test_topk_equals_stable_sort_on_card(card, kind, shape, largest):
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randint(0, 64, shape, generator=g, device=card)
    if kind in ("int32", "cast"):
        x = ((x << 7) | 3).to(torch.int32)
        x[torch.rand(shape, generator=g, device=card) < 0.05] = 2 ** 31 - 1
    if kind != "int32":
        x = x.float()
    if kind == "inf":
        x[:, -shape[1] // 4:] = float("inf")
    if kind == "bins":
        x = torch.where(x < 1, x, -1.0)
    for k in (1, 8, 10, shape[1]):
        f = topk.top_k_largest if largest else topk.top_k_smallest
        v, i = f(x, k)
        sv, si = torch.sort(x, dim=-1, descending=largest, stable=True)
        assert torch.equal(v, sv[:, :k]), k
        assert torch.equal(i, si[:, :k]), k


def _corpus(seed: int = 0):
    rng = np.random.default_rng(seed)
    train = rng.gamma(1.5, 20.0, size=(8192, 128)).astype(np.float32)
    images = [np.clip(train[rng.integers(0, 8192, 64)]
                      + rng.normal(0, 2.0, (64, 128)), 0, 255)
              .astype(np.float32) for _ in range(24)]
    geoms = rng.uniform(0, 512, (24, 64, 4)).astype(np.float32)
    queries = np.stack([np.clip(images[i] + rng.normal(0, 6, (64, 128)),
                                0, 255) for i in range(0, 24, 3)])
    return train, images, geoms, queries.astype(np.float32)


def _agree(ids_a, sc_a, ids_b, sc_b):
    np.testing.assert_allclose(sc_b, sc_a, rtol=RTOL, atol=1e-7)
    near = np.zeros(sc_a.shape, bool)
    gap = np.abs(np.diff(sc_a, axis=1)) <= RTOL * np.abs(sc_a[:, 1:]) + 1e-7
    near[:, 1:] |= gap
    near[:, :-1] |= gap
    assert not ((ids_a != ids_b) & ~near).any()


@pytest.mark.parametrize("hierarchical,probes", [(False, 8), (True, 4),
                                                 (True, 0)])
def test_vocab_he_card_matches_cpu(card, tmp_path, hierarchical, probes):
    """An index trained and prepared on the CPU, carried to the card by
    save / load: encode, query and query_batch agree with the CPU."""
    train, images, geoms, queries = _corpus()
    cpu = VocabHEIndex(n_words=256, hierarchical=hierarchical,
                       probes=probes, device="cpu")
    cpu.train(torch.Generator().manual_seed(0), train, iters=8)
    for i, d in enumerate(images):
        cpu.add_image(d, name=f"im{i}", geometries=geoms[i])
    cpu.prepare()
    path = str(tmp_path / "v.npz")
    cpu.save(path)
    gpu = VocabHEIndex.load(path, device=card)
    gpu.probes = probes
    assert gpu._b_img.device.type == "cuda"
    d = queries.reshape(-1, 128)
    wc, sc = cpu._encode(d)
    wg, sg = gpu._encode(d)
    assert (wg.cpu() != wc).sum() <= len(d) // 500
    assert (sg.cpu() != sc).sum() <= len(d) // 500
    ids_c, sc_c, _ = cpu.query_batch(queries, topk=6)
    ids_g, sc_g, _ = gpu.query_batch(queries, topk=6)
    _agree(ids_c, sc_c, ids_g, sc_g)
    assert [int(j) for j in ids_g[:, 0]] == list(range(0, 24, 3))
    names, s1 = gpu.query(queries[1], topk=6)
    _agree(ids_g[1:2], sc_g[1:2],
           np.array([[int(n[2:]) for n in names]]), s1[None])
    # prepared on the card from the same staged images: the same layout
    gpu2 = VocabHEIndex(n_words=256, hierarchical=hierarchical,
                        probes=probes, device=card)
    for name in ("words", "coarse", "fine", "he_proj", "he_thresh"):
        v = getattr(cpu, name)
        setattr(gpu2, name, None if v is None else v.to(card))
    gpu2._entries, gpu2._names = list(cpu._entries), list(cpu._names)
    gpu2.prepare()
    for name in ("_b_img", "_b_sig", "_t_img", "_e_sigs", "_idf"):
        assert torch.equal(getattr(gpu2, name).cpu(), getattr(cpu, name))
    torch.testing.assert_close(gpu2._self_norm.cpu(), cpu._self_norm,
                               rtol=RTOL, atol=0)


def test_vocab_he_card_scores_repeat_bitwise(card, tmp_path):
    """Scores are float64 sums rounded once (`_score_query_many`), so the
    order in which the card's atomics land cannot move them: 20 calls of
    query_batch give the same scores bitwise. The same index saved and
    loaded on the CPU ranks as the card; on the same words and signatures
    the scoring passes differ only by the per-term float32 rounding of
    exp on each device."""
    from cvt_tpu_torch.index import vocab_he as tv
    train, images, geoms, queries = _corpus()
    gpu = VocabHEIndex(n_words=256, hierarchical=False, probes=8,
                       bucket_cap=8, device=card)
    gpu.train(torch.Generator().manual_seed(0), train, iters=8)
    for i, d in enumerate(images):
        gpu.add_image(d, name=f"im{i}", geometries=geoms[i])
    gpu.prepare()
    assert gpu.n_overflow > 0                  # the tail pass has work
    ids0, sc0, _ = gpu.query_batch(queries, topk=6)
    for _ in range(19):
        ids, sc, _ = gpu.query_batch(queries, topk=6)
        np.testing.assert_array_equal(sc, sc0)
        np.testing.assert_array_equal(ids, ids0)
    path = str(tmp_path / "v.npz")
    gpu.save(path)
    cpu = VocabHEIndex.load(path, device="cpu")
    ids_c, sc_c, _ = cpu.query_batch(queries, topk=6)
    _agree(ids0, sc0, ids_c, sc_c)
    words, sigs = cpu._encode(queries.reshape(-1, 128))
    words, sigs = words.reshape(len(queries), -1), sigs.reshape(
        len(queries), -1)
    valid = torch.ones(words.shape, dtype=torch.bool)
    raw_c = tv._score_query_many(words, sigs, valid, *cpu._layout(),
                                 cpu.n_images)
    raw_g = tv._score_query_many(words.to(card), sigs.to(card),
                                 valid.to(card), *gpu._layout(),
                                 gpu.n_images)
    torch.testing.assert_close(raw_g.cpu(), raw_c, rtol=1e-6, atol=0)
