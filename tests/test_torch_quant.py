"""cvt_tpu_torch.quant (ProductQuantizer, OPQ) and convert held against
cvt_tpu on the same numpy inputs.

Tolerances: encode codes >= 99.9% of rows equal, every mismatch a
near-tie (f32 distance gap < 1e-4 relative); decode/LUT/sqnorms f32 rtol
1e-5; _procrustes 1e-4; a port-trained OPQ's reconstruction MSE within 2%
of a JAX-trained one on the same data."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.quant import OPQ as JOPQ
from cvt_tpu.quant import ProductQuantizer as JPQ
from cvt_tpu.quant import opq as jopq_mod
from cvt_tpu_torch.convert import opq_from_numpy, pq_from_numpy
from cvt_tpu_torch.quant import OPQ, ProductQuantizer
from cvt_tpu_torch.quant import opq as topq_mod

t = torch.from_numpy


@pytest.fixture(scope="module")
def jax_pq(sift_like):
    base, _ = sift_like
    return JPQ.train(jax.random.key(0), base[:2048], m=8, k=64, iters=6)


def _assert_codes_match(codes, jcodes, pq_cb, x):
    """>= 99.9% of rows equal; each differing cell a near-tie."""
    codes, jcodes = np.asarray(codes), np.asarray(jcodes)
    rows_equal = np.all(codes == jcodes, axis=1)
    assert rows_equal.mean() >= 0.999, rows_equal.mean()
    m, _, ds = pq_cb.shape
    xs = np.asarray(x, np.float64).reshape(len(x), m, ds)
    for r, mm in zip(*np.nonzero(codes != jcodes)):
        d = ((xs[r, mm][None] - pq_cb[mm]) ** 2).sum(-1)
        a, b = d[codes[r, mm]], d[jcodes[r, mm]]
        assert abs(a - b) <= 1e-4 * max(a, b), (r, mm, a, b)


def test_pq_encode_decode_match_reference(jax_pq, sift_like):
    base, queries = sift_like
    cb = np.asarray(jax_pq.codebooks)
    pq = pq_from_numpy(cb)
    codes = pq.encode(base)
    assert codes.dtype == torch.uint8
    _assert_codes_match(codes, jax_pq.encode(base), cb, base)
    jcodes = np.asarray(jax_pq.encode(base))
    np.testing.assert_array_equal(pq.decode(t(jcodes)).numpy(),
                                  np.asarray(jax_pq.decode(jcodes)))
    np.testing.assert_allclose(pq.codeword_sqnorms().numpy(),
                               np.asarray(jax_pq.codeword_sqnorms()),
                               rtol=1e-5)
    for metric in ("l2", "ip"):
        lut = pq.lut(queries[:8], metric)
        jlut = jax_pq.lut(queries[:8], metric)
        np.testing.assert_allclose(lut.numpy(), np.asarray(jlut),
                                   rtol=1e-5, atol=1e-2)
        np.testing.assert_allclose(
            pq.adc_scores(lut, t(jcodes[:100])).numpy(),
            np.asarray(jax_pq.adc_scores(jlut, jcodes[:100])),
            rtol=1e-5, atol=1e-1)
    np.testing.assert_allclose(float(pq.reconstruction_mse(base)),
                               float(jax_pq.reconstruction_mse(base)),
                               rtol=1e-4)


def test_pq_train_from_same_init_matches_reference(jax_pq, sift_like):
    base, _ = sift_like
    init = np.asarray(jax_pq.codebooks)
    pq = ProductQuantizer.train(torch.Generator(), base[:2048], 8, 64,
                                iters=3, init_codebooks=init)
    jpq = JPQ.train(jax.random.key(1), base[:2048], 8, 64, iters=3,
                    init_codebooks=init)
    np.testing.assert_allclose(pq.codebooks.numpy(),
                               np.asarray(jpq.codebooks), rtol=1e-4,
                               atol=1e-3)
    with pytest.raises(ValueError):
        ProductQuantizer.train(torch.Generator(), base[:64], 7, 8)


def test_procrustes_matches_reference(rng):
    x = rng.normal(size=(256, 16)).astype(np.float32)
    yhat = (x @ np.linalg.qr(rng.normal(size=(16, 16)))[0]
            + 0.1 * rng.normal(size=(256, 16))).astype(np.float32)
    r = topq_mod._procrustes(t(x), t(yhat)).numpy()
    jr = np.asarray(jopq_mod._procrustes(jnp.asarray(x), jnp.asarray(yhat)))
    np.testing.assert_allclose(r, jr, atol=1e-4)
    np.testing.assert_allclose(r @ r.T, np.eye(16), atol=1e-4)


@pytest.mark.parametrize("init", ["random", "identity"])
def test_opq_train_reaches_reference_mse(init, sift_like):
    base, _ = sift_like
    kw = dict(m=8, k=32, opq_iters=3, kmeans_iters=5, final_kmeans_iters=8,
              init=init)
    jopq = JOPQ.train(jax.random.key(0), base[:2048], **kw)
    opq = OPQ.train(torch.Generator().manual_seed(0), base[:2048], **kw)
    mse = float(opq.reconstruction_mse(base))
    jmse = float(jopq.reconstruction_mse(base))
    assert abs(mse - jmse) <= 0.02 * jmse, (mse, jmse)
    r = opq.rotation.numpy()
    np.testing.assert_allclose(r @ r.T, np.eye(128), atol=1e-4)
    with pytest.raises(ValueError):
        OPQ.train(torch.Generator(), base[:256], m=8, k=8, opq_iters=1,
                  init="bogus")


def test_opq_carried_across_and_persisted(sift_like, tmp_path):
    base, queries = sift_like
    jopq = JOPQ.train(jax.random.key(2), base[:1024], m=8, k=16,
                      opq_iters=1, kmeans_iters=2, final_kmeans_iters=2)
    opq = opq_from_numpy(np.asarray(jopq.rotation),
                         np.asarray(jopq.pq.codebooks))
    np.testing.assert_allclose(opq.rotate(queries).numpy(),
                               np.asarray(jopq.rotate(queries)), rtol=1e-5,
                               atol=1e-3)
    _assert_codes_match(opq.encode(base), jopq.encode(base),
                        np.asarray(jopq.pq.codebooks),
                        np.asarray(jopq.rotate(base)))
    jcodes = np.asarray(jopq.encode(base[:64]))
    np.testing.assert_allclose(opq.decode(t(jcodes)).numpy(),
                               np.asarray(jopq.decode(jcodes)), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(opq.lut(queries[:4]).numpy(),
                               np.asarray(jopq.lut(queries[:4])), rtol=1e-5,
                               atol=1e-1)
    # .npz written by either package loads in the other
    opq.save(str(tmp_path / "t.npz"))
    jopq.save(str(tmp_path / "j.npz"))
    back = JOPQ.load(str(tmp_path / "t.npz"))
    np.testing.assert_array_equal(np.asarray(back.rotation),
                                  opq.rotation.numpy())
    loaded = OPQ.load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(loaded.pq.codebooks.numpy(),
                                  np.asarray(jopq.pq.codebooks))
    opq.pq.save(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(
        np.asarray(JPQ.load(str(tmp_path / "p.npz")).codebooks),
        ProductQuantizer.load(str(tmp_path / "p.npz")).codebooks.numpy())
