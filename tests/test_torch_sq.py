"""cvt_tpu_torch's int8-SQ lane and PCA held against cvt_tpu on the same
numpy inputs (Pallas with interpret=True on the CPU).

Tolerances:
  * bitwise: SQ codes (same vmin/vdiff, same normalized input), the int8
    query rounding and the ids of search(mode="int8") with term3 carried
    across, search_fast ids and the cached twin's segpack/tiletop with
    `cvt_tpu`'s decoded cache and norm column carried across;
  * the port's own norm column: rtol 1e-6 (a float32 sum in another
    order; round(norm/qs) sits in every key, so ids may differ at rows
    whose norm/qs lies on a rounding boundary) and top-1 agreement >= 0.99;
  * search(mode="bf16"): top-1 agreement >= 0.99, distances rtol 1e-3;
  * PCA: components up to sign to 1e-4, the carried-across projection
    to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.index.flat_sq import FlatSQIndex as JFlatSQ
from cvt_tpu.ops.linalg import l2_normalize as jl2
from cvt_tpu.ops.pallas import adc_scan as J
from cvt_tpu.quant.pca import PCA as JPCA
from cvt_tpu.quant.sq import ScalarQuantizer as JSQ
from cvt_tpu_torch import convert
from cvt_tpu_torch.index import FlatSQIndex
from cvt_tpu_torch.index.flat_sq import _quantize_query
from cvt_tpu_torch.ops.kernels import adc_scan as T
from cvt_tpu_torch.quant import PCA, ScalarQuantizer

N, D, B = 4096, 64, 64


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    base = np.asarray(jl2(jnp.asarray(
        rng.normal(size=(N, D)).astype(np.float32))))
    q = np.asarray(jl2(jnp.asarray(
        rng.normal(size=(B, D)).astype(np.float32))))
    jsq = JSQ.train(base, l2norm=False)
    jidx = JFlatSQ(jsq, chunk=1024)
    jidx.add(base)
    return base, q, jsq, jidx


def _carry(jidx, mode="bf16", cache=False):
    extra = {}
    if cache:
        extra = dict(dec8_t=np.asarray(jidx._dec8_t),
                     norm_col=np.asarray(jidx._norm_col))
    return convert.flat_sq_from_numpy(
        np.asarray(jidx._codes_s8), np.asarray(jidx._term3),
        np.asarray(jidx.sq.vmin), np.asarray(jidx.sq.vdiff),
        jidx.sq.rounding, mode, device="cpu", **extra)


def test_sq_train_matches(data):
    base, _, jsq, _ = data
    raw = np.random.default_rng(1).normal(size=(500, D)).astype(np.float32)
    for l2norm in (False, True):
        j = JSQ.train(raw, l2norm=l2norm)
        p = ScalarQuantizer.train(raw, l2norm=l2norm, device="cpu")
        np.testing.assert_allclose(p.vmin.numpy(), np.asarray(j.vmin),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(p.vdiff.numpy(), np.asarray(j.vdiff),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rounding", ["truncate", "round"])
def test_sq_codes_bitwise(data, rounding):
    base, _, jsq, _ = data
    j = JSQ(jsq.vmin, jsq.vdiff, rounding)
    p = convert.sq_from_numpy(np.asarray(jsq.vmin), np.asarray(jsq.vdiff),
                              rounding, device="cpu")
    # a constant dimension (vdiff == 0) encodes to 0 in both
    x = base[:1000].copy()
    jc = np.asarray(j.encode(x))
    pc = p.encode(x).numpy()
    np.testing.assert_array_equal(pc, jc)
    # decode cancels near zero: XLA's and PyTorch's float32 steps differ
    # in the last bit, so the tolerance is absolute there
    np.testing.assert_allclose(p.decode(pc).numpy(),
                               np.asarray(j.decode(jc)), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(p.scale.numpy(), np.asarray(j.scale),
                               rtol=1e-7)
    np.testing.assert_allclose(p.bias.numpy(), np.asarray(j.bias),
                               rtol=1e-6)
    vd = np.asarray(jsq.vdiff).copy()
    vd[3] = 0.0
    np.testing.assert_array_equal(
        convert.sq_from_numpy(np.asarray(jsq.vmin), vd, rounding,
                              device="cpu").encode(x).numpy(),
        np.asarray(JSQ(jsq.vmin, jnp.asarray(vd), rounding).encode(x)))
    with pytest.raises(ValueError):
        ScalarQuantizer(p.vmin, p.vdiff, "floor").encode(x)


def test_sq_reconstruction_loss_and_save_load(data, tmp_path):
    base, _, jsq, _ = data
    p = convert.sq_from_numpy(np.asarray(jsq.vmin), np.asarray(jsq.vdiff),
                              device="cpu")
    # base is normalized already; normalizing again inside would differ
    # in the last bit (rsqrt) and flip codes at truncation boundaries
    l2, ip = p.reconstruction_loss(base[:512], l2norm=False)
    jl2_, jip = jsq.reconstruction_loss(base[:512], l2norm=False)
    np.testing.assert_allclose(float(l2), float(jl2_), rtol=1e-5)
    np.testing.assert_allclose(float(ip), float(jip), rtol=1e-5)
    p.save(str(tmp_path / "p.npz"))
    jsq.save(str(tmp_path / "j.npz"))
    back = JSQ.load(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(np.asarray(back.vmin), np.asarray(jsq.vmin))
    mine = ScalarQuantizer.load(str(tmp_path / "j.npz"), device="cpu")
    assert mine.rounding == jsq.rounding
    np.testing.assert_array_equal(mine.vdiff.numpy(), np.asarray(jsq.vdiff))


def test_add_matches_reference_layout(data):
    base, _, jsq, jidx = data
    p = FlatSQIndex(convert.sq_from_numpy(np.asarray(jsq.vmin),
                                          np.asarray(jsq.vdiff),
                                          device="cpu"))
    p.add(base[:3000])
    p.add(base[3000:])
    assert p.ntotal == N and p.dim == D
    np.testing.assert_array_equal(p._codes_s8.numpy(),
                                  np.asarray(jidx._codes_s8))
    np.testing.assert_allclose(p._term3.numpy(), np.asarray(jidx._term3),
                               rtol=1e-6)


def test_int8_query_rounding_bitwise(data):
    rng = np.random.default_rng(5)
    r = rng.normal(0, 0.01, size=(B, D)).astype(np.float32)
    gamma, tq = _quantize_query(torch.from_numpy(r))
    jr = jnp.asarray(r)
    jg = jnp.maximum(jnp.max(jnp.abs(jr), axis=-1, keepdims=True) / 127.0,
                     1e-30)
    np.testing.assert_array_equal(gamma.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(
        tq.numpy(), np.asarray(jnp.round(jr / jg).astype(jnp.int8)))


def test_search_int8_bitwise_with_term3_carried(data):
    _, q, _, jidx = data
    jidx.mode = "int8"
    try:
        jd, ji = jidx.search(q, 10)
    finally:
        jidx.mode = "bf16"
    d, i = _carry(jidx, "int8").search(q, 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)


def test_search_bf16(data):
    _, q, _, jidx = data
    jd, ji = jidx.search(q, 10)
    p = _carry(jidx)
    p.chunk = 1024
    d, i = p.search(q, 10)
    assert (i.numpy()[:, 0] == np.asarray(ji)[:, 0]).mean() >= 0.99
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-3,
                               atol=1e-4)
    # k past n clips, an empty index raises
    small = _carry(jidx)
    small._codes_s8, small._term3 = small._codes_s8[:7], small._term3[:7]
    assert small.search(q, 10)[1].shape == (B, 7)
    with pytest.raises(RuntimeError):
        FlatSQIndex(small.sq).search(q, 10)


def test_search_fast_bitwise_with_cache_carried(data):
    _, q, _, jidx = data
    jd, ji = jidx.search_fast(q, 10, interpret=True)
    p = _carry(jidx, cache=True)
    d, i = p.search_fast(q, 10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-6)
    # the cached twin itself, at search_fast's own fold and tile
    b_vec = jidx.sq.bias + 128.0 * jidx.sq.scale
    qj = jnp.asarray(q) - b_vec[None, :]
    vcap, _ = J._pack_caps(128, D)
    q2s, qs = J._fold_queries(qj, jidx.sq.scale, jnp.max(jidx._norm_col),
                              vcap)
    tile = T.cached_tile_n(jidx._dec8_t.shape[1])
    sp, tt = J._adc_segmin_cached(q2s, qs, jidx._dec8_t, jidx._norm_col, N,
                                  tile, 128, True)
    tq2s, tqs = T._fold_queries(torch.from_numpy(np.asarray(qj)),
                                p.sq.scale, torch.amax(p._norm_col), vcap)
    np.testing.assert_array_equal(tq2s.numpy(), np.asarray(q2s))
    tsp, ttt = T.adc_segmin_cached(tq2s, tqs, p._dec8_t, p._norm_col, N,
                                   tile)
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(sp))
    np.testing.assert_array_equal(ttt[:, :4].numpy(), np.asarray(tt)[:, :4])


def test_search_fast_own_cache(data):
    _, q, _, jidx = data
    jd, ji = jidx.search_fast(q, 10, interpret=True)
    p = _carry(jidx)
    d, i = p.search_fast(q, 10)
    np.testing.assert_array_equal(p._dec8_t.numpy(), np.asarray(jidx._dec8_t))
    np.testing.assert_allclose(p._norm_col.numpy(),
                               np.asarray(jidx._norm_col), rtol=1e-6)
    assert (i.numpy()[:, 0] == np.asarray(ji)[:, 0]).mean() >= 0.99
    assert i.min() >= 0 and i.max() < N
    # adding rows rebuilds the cache
    p.add(codes=np.full((5, D), 255, np.uint8))
    d, i = p.search_fast(q, 10)
    assert p._dec8_n == N + 5 and p._dec8_t.shape[1] == 5120


def test_search_fast_wide_vectors():
    """Above d 346 the packed int32 keys of seg 128 overflow: cvt_tpu's
    search_fast raises there, the port halves the segment (64 at d 512)
    and its top-1 equals the bf16 engine's on the same index."""
    rng = np.random.default_rng(12)
    base = rng.normal(size=(2048, 512)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    q = base[:32] + 0.05 * rng.normal(size=(32, 512)).astype(np.float32)
    jidx = JFlatSQ(JSQ.train(base, l2norm=False), chunk=1024)
    jidx.add(base)
    with pytest.raises(ValueError, match="infeasible"):
        jidx.search_fast(q, 5)
    assert [T.cached_seg(d) for d in (64, 346, 347, 693, 694)] == [
        128, 128, 64, 64, 32]
    idx = FlatSQIndex(ScalarQuantizer.train(base, device="cpu"))
    idx.add(base)
    _, i_fast = idx.search_fast(q, 5)
    _, i_bf16 = idx.search(q, 5)
    np.testing.assert_array_equal(i_fast[:, 0].numpy(), i_bf16[:, 0].numpy())
    np.testing.assert_array_equal(i_fast[:, 0].numpy(), np.arange(32))


def test_flat_sq_save_load_both_ways(data, tmp_path):
    _, q, _, jidx = data
    p = _carry(jidx)
    p.save(str(tmp_path / "p.npz"))
    j2 = JFlatSQ.load(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(np.asarray(j2._codes_s8),
                                  np.asarray(jidx._codes_s8))
    jidx.save(str(tmp_path / "j.npz"))
    p2 = FlatSQIndex.load(str(tmp_path / "j.npz"), device="cpu")
    assert p2.mode == jidx.mode and p2.sq.rounding == jidx.sq.rounding
    d1, i1 = p.search(q[:8], 5)
    d2, i2 = p2.search(q[:8], 5)
    np.testing.assert_array_equal(i1.numpy(), i2.numpy())
    np.testing.assert_array_equal(d1.numpy(), d2.numpy())


@pytest.fixture(scope="module")
def pca_data():
    rng = np.random.default_rng(3)
    basis = np.linalg.qr(rng.normal(size=(32, 6)))[0]
    z = rng.normal(size=(3000, 6)) * [10, 7, 5, 3, 2, 1]
    x = (z @ basis.T + 0.01 * rng.normal(size=(3000, 32))).astype(np.float32)
    return x


def test_pca_train_matches_up_to_sign(pca_data):
    x = pca_data
    j = JPCA.train(x, 6)
    p = PCA.train(x, 6, device="cpu")
    jc = np.asarray(j.components)
    pc = p.components.numpy()
    sign = np.sign(np.sum(jc * pc, axis=1, keepdims=True))
    np.testing.assert_allclose(pc * sign, jc, atol=1e-4)
    np.testing.assert_allclose(p.eigenvalues.numpy(),
                               np.asarray(j.eigenvalues), rtol=1e-4)
    np.testing.assert_allclose(p.mean.numpy(), np.asarray(j.mean), rtol=1e-5,
                               atol=1e-6)
    assert np.all(np.diff(p.eigenvalues.numpy()) <= 0)


@pytest.mark.parametrize("whiten", [False, True])
def test_pca_project_carried(pca_data, whiten):
    x = pca_data
    j = JPCA.train(x, 6, whiten=whiten)
    p = convert.pca_from_numpy(np.asarray(j.mean), np.asarray(j.components),
                               np.asarray(j.eigenvalues), whiten,
                               device="cpu")
    assert (p.in_dim, p.out_dim) == (32, 6)
    y = p.project(x[:200]).numpy()
    np.testing.assert_allclose(y, np.asarray(j.project(x[:200])), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(
        p.project(x[:200], l2norm=True).numpy(),
        np.asarray(j.project(x[:200], l2norm=True)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.reconstruct(y).numpy(),
                               np.asarray(j.reconstruct(y)), rtol=1e-5,
                               atol=1e-4)


def test_pca_save_load_both_ways(pca_data, tmp_path):
    x = pca_data
    j = JPCA.train(x, 4, whiten=True)
    j.save(str(tmp_path / "j.npz"))
    p = PCA.load(str(tmp_path / "j.npz"), device="cpu")
    assert p.whiten
    np.testing.assert_allclose(p.project(x[:10]).numpy(),
                               np.asarray(j.project(x[:10])), rtol=1e-5,
                               atol=1e-5)
    p.save(str(tmp_path / "p.npz"))
    j2 = JPCA.load(str(tmp_path / "p.npz"))
    np.testing.assert_array_equal(np.asarray(j2.components),
                                  p.components.numpy())
