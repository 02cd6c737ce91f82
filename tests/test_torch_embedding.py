"""The port's global embeddings (`cvt_tpu_torch.features.embedding`,
`features.text`, `ops.resize`, `convert.embedding_from_numpy`) held to
`cvt_tpu.features.embedding` / `features.text` on the same seeded numpy
inputs, on the CPU.

Tolerances: JAX's antialiased linear resize 1e-5 on [0, 1] values (down
480 x 640 -> 224 and -> 32, up 48 x 56 -> 64; its weight matrices 1e-7);
a "SAME" stride-2 convolution 1e-5 against `lax.conv_general_dilated`;
the simple CNN carried across by `convert.embedding_from_numpy`:
embeddings 1e-4 relative to the largest component, norms 1 +- 1e-4;
TextEmbedder tables bitwise (numpy's default_rng), word and sentence
embeddings 1e-6; embed_ids 1e-6; TextEmbedding 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.features import embedding as je
from cvt_tpu.features import text as jt
from cvt_tpu_torch import convert
from cvt_tpu_torch.features import embedding as te
from cvt_tpu_torch.features import text as tt
from cvt_tpu_torch.ops.resize import linear_weights, resize_linear


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape,out", [
    ((2, 480, 640), (2, 224, 224)), ((2, 480, 640), (2, 32, 32)),
    ((3, 48, 56), (3, 64, 64)), ((2, 480, 640, 3), (2, 224, 224, 3)),
    ((2, 48, 56, 3), (2, 64, 64, 3)), ((2, 30, 40), (2, 30, 17))])
def test_resize_matches_jax_image_resize(shape, out):
    x = np.random.default_rng(0).random(shape).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, method="linear"))
    got = resize_linear(t(x), out).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_in,n_out", [(480, 224), (640, 224), (480, 32),
                                        (48, 64), (56, 64), (7, 3)])
def test_resize_weights_match_jax(n_in, n_out):
    from jax._src.image.scale import (_fill_triangle_kernel,
                                      compute_weight_mat)
    want = np.asarray(compute_weight_mat(n_in, n_out, n_out / n_in, 0.0,
                                         _fill_triangle_kernel, True))
    np.testing.assert_allclose(linear_weights(n_in, n_out), want.T, rtol=0,
                               atol=1e-7)


@pytest.mark.parametrize("h,w", [(224, 224), (112, 112), (63, 64), (7, 5)])
def test_same_padding_matches_xla(h, w):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    wt = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    want = np.asarray(je._conv(jnp.asarray(x), jnp.asarray(wt), stride=2))
    got = te._conv(t(x).permute(0, 3, 1, 2),
                   t(wt).permute(3, 2, 0, 1), stride=2).permute(0, 2, 3, 1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    # F.conv2d(padding=1) pads 1 on each side: another answer at even sizes
    if h % 2 == 0:
        assert te._same_pad(h, 3, 2) == (0, 1)


def test_preprocess_matches():
    imgs = (np.random.default_rng(2).random((3, 120, 160, 3)) * 255).astype(
        np.uint8)
    want = np.asarray(je.preprocess(jnp.asarray(imgs), size=64))
    got = te.preprocess(t(imgs), size=64).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


@pytest.mark.parametrize("dim,size,shape", [
    (32, 64, (5, 48, 56, 3)), (128, 224, (2, 480, 640, 3)),
    (16, 63, (3, 40, 50, 3))])
def test_simple_cnn_through_converter(dim, size, shape):
    imgs = (np.random.default_rng(3).random(shape) * 255).astype(np.uint8)
    params, head = je._init_simple_cnn(jax.random.key(0), dim)
    want_ext = je.EmbeddingExtractor.simple_cnn(dim=dim, seed=0,
                                                input_size=size)
    ext = convert.embedding_from_numpy([np.asarray(p) for p in params],
                                       np.asarray(head), input_size=size,
                                       device="cpu")
    assert ext.dim == dim and ext.device == torch.device("cpu")
    for l2norm in (True, False):
        want = np.asarray(want_ext.compute(imgs, batch_size=2,
                                           l2norm=l2norm))
        got = ext.compute(imgs, batch_size=2, l2norm=l2norm).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    norms = np.linalg.norm(ext.compute(imgs, batch_size=3).numpy(), axis=1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-4)


def test_simple_cnn_own_weights():
    """The port's own He-init: seeded, deterministic, batch-invariant."""
    imgs = (np.random.default_rng(4).random((5, 48, 56, 3)) * 255).astype(
        np.uint8)
    a = te.EmbeddingExtractor.simple_cnn(dim=32, input_size=64, device="cpu")
    b = te.EmbeddingExtractor.simple_cnn(dim=32, input_size=64, device="cpu")
    e1 = a.compute(imgs, batch_size=2).numpy()
    e2 = b.compute(imgs, batch_size=5).numpy()
    assert e1.shape == (5, 32)
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(e1, axis=1), 1.0, rtol=1e-4)
    params, head = te._init_simple_cnn(torch.Generator().manual_seed(0), 32)
    assert [tuple(p.shape) for p in params] == [
        (3, 3, 3, 32), (3, 3, 32, 64), (3, 3, 64, 128), (3, 3, 128, 256)]
    np.testing.assert_allclose(
        te._simple_cnn_forward(params, head, te.preprocess(
            t(imgs), size=64)).numpy(),
        a.compute(imgs, l2norm=False).numpy(), rtol=1e-5, atol=1e-6)


def test_text_embedding_from_txt(tmp_path):
    p = tmp_path / "vecs.vec"
    p.write_text("3 4\nhello 1 0 0 0\nworld 0 1 0 0\nfoo 0 0 3 4\n")
    q = tmp_path / "nohead.vec"
    q.write_text("hello 1 2 0 0\nworld 0 1 0 5\n")
    for path in (p, q):
        want_t = je.TextEmbedding.from_txt(str(path))
        got_t = te.TextEmbedding.from_txt(str(path), device="cpu")
        assert got_t.vocab == want_t.vocab
        words = ["foo", "missing", "hello", "world"]
        for l2norm in (True, False):
            np.testing.assert_allclose(
                got_t.embed(words, l2norm=l2norm).numpy(),
                np.asarray(want_t.embed(words, l2norm=l2norm)), rtol=0,
                atol=1e-6)
    e = te.TextEmbedding.from_txt(str(p), device="cpu").embed(["foo"])
    np.testing.assert_allclose(e.numpy()[0], [0, 0, 0.6, 0.8], atol=1e-6)


WORDS = ["red", "blue", "car", "truck", "sky", "cat", "dog", "fish"]


@pytest.mark.parametrize("seed,dim,buckets", [(0, 32, 512), (1, 48, 4096)])
def test_text_embedder_matches(seed, dim, buckets):
    want_e = jt.TextEmbedder.random(WORDS, dim=dim, n_buckets=buckets,
                                    seed=seed)
    got_e = tt.TextEmbedder.random(WORDS, dim=dim, n_buckets=buckets,
                                   seed=seed, device="cpu")
    np.testing.assert_array_equal(got_e.vectors.numpy(),
                                  np.asarray(want_e.vectors))
    np.testing.assert_array_equal(got_e.ngrams.numpy(),
                                  np.asarray(want_e.ngrams))
    words = ["cat", "catt", "zebra", "dog", "cat", "ünïcode", "a"]
    np.testing.assert_allclose(got_e.embed_words(words).numpy(),
                               np.asarray(want_e.embed_words(words)),
                               rtol=0, atol=1e-6)
    sents = ["red car", "blue zebra dog", "fish", "sky sky truck carr"]
    np.testing.assert_allclose(got_e.embed_sentences(sents).numpy(),
                               np.asarray(want_e.embed_sentences(sents)),
                               rtol=0, atol=1e-6)


def test_text_embedder_without_ngrams_and_helpers():
    vecs = np.random.default_rng(5).normal(size=(3, 8)).astype(np.float32)
    vocab = {"a": 0, "b": 1, "c": 2}
    want = jt.TextEmbedder(vocab, vecs).embed_words(["a", "zz", "c"])
    got = tt.TextEmbedder(vocab, vecs, device="cpu").embed_words(
        ["a", "zz", "c"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert not got[1].any()
    assert tt.char_ngrams("where") == jt.char_ngrams("where")
    assert tt.char_ngrams("ab", 2, 3) == jt.char_ngrams("ab", 2, 3)
    for s in (b"", b"abc", "ngrām".encode()):
        assert tt._fnv1a(s) == jt._fnv1a(s)


def test_embed_ids_matches():
    rng = np.random.default_rng(6)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    ids = rng.integers(0, 64, (12, 9))
    mask = (rng.random((12, 9)) < 0.7).astype(np.float32)
    mask[3] = 0.0                                    # an empty row
    want = np.asarray(jt.embed_ids(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(mask)))
    got = tt.embed_ids(t(table), t(ids), t(mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got_np = tt.embed_ids(table, ids, mask, device="cpu").numpy()
    np.testing.assert_allclose(got_np, want, rtol=0, atol=1e-6)
