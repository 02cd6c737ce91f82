"""The whole slice: an OPQ trained by cvt_tpu, carried across with
cvt_tpu_torch.convert, then add + search in both packages on the same
data (N = 4096, CPU; the port's kernel engine runs its twins here).

Tolerances: fast-path and exact-path ids equal; f32 distances rtol 1e-5;
encode codes >= 99.9% of rows equal (mismatches near-ties); within the
bf16 reference engine, distances rtol 1e-3 and top-1 ids equal except at
near-ties (the tie-aware check of tests/test_pallas.py)."""

import jax
import numpy as np
import pytest
import torch

from cvt_tpu.index import FlatADCIndex as JFlatADCIndex
from cvt_tpu.index import flat_adc as jflat_adc
from cvt_tpu.quant import OPQ as JOPQ
from cvt_tpu_torch.convert import flat_adc_from_numpy, opq_from_numpy
from cvt_tpu_torch.index import FlatADCIndex, FlatIndex
from cvt_tpu_torch.index import flat_adc as tflat_adc
from cvt_tpu_torch.io import synthetic_sift
from cvt_tpu_torch.quant import OPQ, ProductQuantizer
from cvt_tpu_torch.utils import recall_at_k

t = torch.from_numpy


@pytest.fixture(scope="module")
def slice_setup(sift_like):
    base, queries = sift_like
    jopq = JOPQ.train(jax.random.key(0), base[:2048], m=8, k=64,
                      opq_iters=2, kmeans_iters=4, final_kmeans_iters=4)
    opq = opq_from_numpy(np.asarray(jopq.rotation),
                         np.asarray(jopq.pq.codebooks), device="cpu")
    jidx = JFlatADCIndex(jopq, impl="pallas")
    jidx.add(base)
    idx = FlatADCIndex(opq, impl="kernel")
    idx.add(base)
    return base, queries, jopq, opq, jidx, idx


def _codes_agree(codes, jcodes, codebooks, y):
    """Fraction of equal rows; every differing cell must be a near-tie
    (f32 distance gap below 1e-4 relative) of the rotated vectors y."""
    codes, jcodes = np.asarray(codes), np.asarray(jcodes)
    cb = np.asarray(codebooks, np.float64)
    m, _, ds = cb.shape
    ys = np.asarray(y, np.float64).reshape(len(y), m, ds)
    for r, mm in zip(*np.nonzero(codes != jcodes)):
        d = ((ys[r, mm][None] - cb[mm]) ** 2).sum(-1)
        a, b = d[codes[r, mm]], d[jcodes[r, mm]]
        assert abs(a - b) <= 1e-4 * max(a, b), (r, mm, a, b)
    return np.all(codes == jcodes, axis=1).mean()


def test_add_encodes_like_reference(slice_setup):
    base, _, jopq, opq, jidx, idx = slice_setup
    idx._materialize()
    jidx._materialize()
    assert _codes_agree(idx._codes.numpy(), jidx._codes, jopq.pq.codebooks,
                        jopq.rotate(base)) >= 0.999
    same = np.all(idx._codes.numpy() == np.asarray(jidx._codes), axis=1)
    np.testing.assert_allclose(idx._dec_sq.numpy()[same],
                               np.asarray(jidx._dec_sq)[same], rtol=1e-5)
    # add() and encode() agree inside the port (full-precision f32)
    np.testing.assert_array_equal(idx._codes.numpy(),
                                  opq.encode(base).numpy())


def test_encode_chunk_matches_reference(slice_setup):
    base, _, jopq, opq, _, _ = slice_setup
    c, d = tflat_adc._encode_chunk(t(base[:1000]), opq.rotation,
                                   opq.pq.codebooks)
    jc, jd = jflat_adc._encode_chunk(base[:1000], jopq.rotation,
                                     jopq.pq.codebooks, True)
    assert _codes_agree(c.numpy(), jc, jopq.pq.codebooks,
                        jopq.rotate(base[:1000])) >= 0.999
    same = np.all(c.numpy() == np.asarray(jc), axis=1)
    np.testing.assert_allclose(d.numpy()[same], np.asarray(jd)[same],
                               rtol=1e-5)


@pytest.mark.parametrize("exact", [False, True])
def test_search_ids_match_reference(slice_setup, exact):
    _, queries, _, _, jidx, idx = slice_setup
    # the same codes in both, so the comparison is of the search alone
    idx2 = flat_adc_from_numpy(np.asarray(jidx._codes),
                               np.asarray(jidx._dec_sq),
                               np.asarray(jidx.pq.codebooks),
                               np.asarray(jidx.rotation), device="cpu",
                               impl="kernel")
    d, i = idx2.search(queries, 10, exact=exact)
    jd, ji = jidx.search(queries, 10, exact=exact)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)
    # and end to end from raw vectors through the port's own encode
    d, i = idx.search(queries, 10, exact=exact)
    assert np.mean(i.numpy()[:, 0] == np.asarray(ji)[:, 0]) >= 0.95
    assert int(i.max()) < idx.ntotal


def test_decoded_cache_matches_fast_path(slice_setup):
    _, queries, _, opq, jidx, idx = slice_setup
    fresh = FlatADCIndex(opq, impl="kernel")
    fresh.add(codes=idx._codes)
    d0, i0 = fresh.search(queries[:16], 10)
    fresh.build_decoded_cache()
    assert fresh._dec8_n == fresh.ntotal
    d1, i1 = fresh.search(queries[:16], 10)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    real = d0.numpy() < 1e7
    np.testing.assert_allclose(d0.numpy()[real], d1.numpy()[real],
                               rtol=1e-5, atol=0.5)
    # and against the reference's own cached scan on the same codes
    j2 = JFlatADCIndex(jidx.pq.__class__(jidx.pq.codebooks), impl="pallas")
    j2.rotation = jidx.rotation
    j2.add(codes=idx._codes.numpy())
    j2.build_decoded_cache()
    _, ji = j2.search(queries[:16], 10)
    assert np.mean(i1.numpy()[:, 0] == np.asarray(ji)[:, 0]) >= 0.95


def test_adc_scan_reference_engine(slice_setup):
    base, queries, jopq, opq, jidx, _ = slice_setup
    idx = flat_adc_from_numpy(np.asarray(jidx._codes),
                              np.asarray(jidx._dec_sq),
                              np.asarray(jidx.pq.codebooks),
                              np.asarray(jidx.rotation), device="cpu",
                              impl="scan")
    jx = JFlatADCIndex(jopq, chunk=1024, impl="xla")
    jx.add(codes=np.asarray(jidx._codes))
    idx.chunk = 1024
    d, i = idx.search(queries, 10)
    jd, ji = jx.search(queries, 10)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-3)
    # tie-aware top-1: where ids differ, the two distances are near-equal
    diff = i.numpy()[:, 0] != np.asarray(ji)[:, 0]
    np.testing.assert_allclose(d.numpy()[diff, 0], np.asarray(jd)[diff, 0],
                               rtol=1e-3)
    assert diff.mean() <= 0.1
    # the bf16 decode equals the reference's one-hot bf16 product
    codes = np.array(jidx._codes)[:300]
    np.testing.assert_array_equal(
        tflat_adc._decode_chunk_bf16(t(codes), opq.pq.codebooks)
        .float().numpy(),
        np.asarray(jflat_adc._decode_chunk_bf16(
            codes.astype(np.int32), jopq.pq.codebooks)).astype(np.float32))


def test_save_load_both_directions(slice_setup, tmp_path):
    _, queries, _, _, jidx, idx = slice_setup
    idx.save(str(tmp_path / "port.npz"))
    jidx.save(str(tmp_path / "jax.npz"))
    zp, zj = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(zp.files) == set(zj.files)
    for key in zp.files:
        assert zp[key].dtype == zj[key].dtype, key
        assert zp[key].shape == zj[key].shape, key
    # port -> reference and reference -> port give equal search results
    back = JFlatADCIndex.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back._codes),
                                  idx._codes.numpy())
    loaded = FlatADCIndex.load(str(tmp_path / "jax.npz"), device="cpu")
    loaded.impl = "kernel"
    _, i1 = loaded.search(queries[:16], 10)
    jidx2 = JFlatADCIndex.load(str(tmp_path / "jax.npz"))
    jidx2.impl = "pallas"
    _, ji = jidx2.search(queries[:16], 10)
    np.testing.assert_array_equal(i1.numpy(), np.asarray(ji))
    again = FlatADCIndex.load(str(tmp_path / "port.npz"), device="cpu")
    again.impl = "kernel"
    _, i2 = again.search(queries[:16], 10)
    _, i3 = idx.search(queries[:16], 10)
    np.testing.assert_array_equal(i2.numpy(), i3.numpy())


def test_index_api_edges(sift_like):
    base, queries = sift_like
    pq = ProductQuantizer.train(torch.Generator().manual_seed(0),
                                base[:1024], m=8, k=16, iters=2,
                                device="cpu")
    idx = FlatADCIndex(pq)
    assert idx._resolve_impl() == "scan"
    with pytest.raises(RuntimeError):
        idx.search(queries[:2], 1)
    with pytest.raises(ValueError):
        FlatADCIndex(pq, impl="xla")
    with pytest.raises(TypeError):
        FlatADCIndex(object())
    idx.add(base[:100])
    idx.add(base[100:200])
    assert idx.ntotal == 200
    d, i = idx.search(queries[:3], 500)          # k clipped to ntotal
    assert i.shape == (3, 200) and int(i.max()) < 200
    # 200 rows fill two 128-row segments, so the fast path has two real
    # candidates per query; the rest carry sentinel keys, as in cvt_tpu
    kern = FlatADCIndex(pq, impl="kernel")
    kern.add(base[:200])
    d, i = kern.search(queries[:3], 10)
    assert int(i[:, :2].max()) < 200 and np.isfinite(d.numpy()).all()
    d, i = kern.search(queries[:3], 10, exact=True)
    assert int(i.max()) < 200 and np.isfinite(d.numpy()).all()


def test_port_pipeline_recall_on_cpu():
    """The chip_smoke main path at a small size, all on the CPU: OPQ train
    in the port, encode, fast/exact/cached search, exact ground truth."""
    base, queries = synthetic_sift(8192, 128, n_queries=64, seed=0)
    opq = OPQ.train(torch.Generator().manual_seed(0), base[:4096], m=8,
                    k=32, opq_iters=2, kmeans_iters=3, final_kmeans_iters=4,
                    device="cpu")
    idx = FlatADCIndex(opq, impl="kernel")
    idx.add(base)
    exact = FlatIndex(128, device="cpu")
    exact.add(base)
    _, gt = exact.search(queries, 1)
    _, fast = idx.search(queries, 10)
    _, ex = idx.search(queries, 10, exact=True)
    idx.build_decoded_cache()
    _, cached = idx.search(queries, 10)
    # the cached scan takes another tile size here (1024 vs 2048), so only
    # top-1 is common to both by the segment lemma
    np.testing.assert_array_equal(cached[:, 0].numpy(), fast[:, 0].numpy())
    ref = FlatADCIndex(opq, impl="scan")
    ref.add(codes=idx._codes)
    _, ids_ref = ref.search(queries, 10)
    r_fast = recall_at_k(fast, gt[:, 0], k=10)
    r_ref = recall_at_k(ids_ref, gt[:, 0], k=10)
    assert r_fast > 0.3 and abs(r_fast - r_ref) <= 0.1
    assert recall_at_k(ex, gt[:, 0], k=10) >= r_fast - 0.05
