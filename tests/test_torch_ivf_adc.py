"""IVF-ADC in both packages on the same data (N = 4096, CPU; the port's
search_fast runs its kernel's twin here, cvt_tpu's the Pallas kernel in
interpret mode). A cvt_tpu index is trained and carried across with
cvt_tpu_torch.convert.ivf_adc_from_numpy.

Tolerances: build_from_codes arrays bitwise; the port's own encode
>= 99.9% of assignments and codes equal, every mismatch a near-tie (f32
distance gap <= 1e-4 relative); every search: distances rtol 1e-5, ids
equal except at near-ties (see test_torch_ivf_scan.assert_ids_match),
counts and n_dropped equal."""

import jax
import numpy as np
import pytest
import torch

from cvt_tpu.index import FlatIndex as JFlatIndex
from cvt_tpu.index import IVFADCIndex as JIVFADCIndex
from cvt_tpu_torch.convert import ivf_adc_from_numpy
from cvt_tpu_torch.index import IVFADCIndex
from cvt_tpu_torch.utils import recall_at_k
from test_torch_ivf_scan import assert_ids_match

N_GROUPS = 50


@pytest.fixture(scope="module")
def ivf_setup(sift_like):
    base, queries = sift_like
    groups = np.random.default_rng(1).integers(0, N_GROUPS, base.shape[0])
    groups = groups.astype(np.int32)
    # a bucket capacity below the mean list (128) sends entries to the tail
    jidx = JIVFADCIndex(coarse_k=32, m=8, k=32, bucket_cap=96)
    jidx.train(jax.random.key(0), base[:2048], coarse_iters=5, pq_iters=5)
    a, c, dq = map(np.array, jidx.encode_chunk(base))
    jidx.build_from_codes(a, c, dq, group_ids=groups)
    idx = ivf_adc_from_numpy(np.asarray(jidx.centroids),
                             np.asarray(jidx.pq.codebooks), bucket_cap=96)
    idx.build_from_codes(a, c, dq, group_ids=groups)
    return base, queries, groups, jidx, idx, (a, c, dq)


def _arrays(idx, tail):
    """Every array of a built index, by its save() key."""
    names = ("buckets", "bucket_ids", "bucket_dsq", "pg_dec8_t",
             "pg_dec16", "pg_srow16", "pg_nrm", "pg_seg_cell", "pg_rowids",
             "pg_srow", "vec_groups")
    out = {key: np.asarray(getattr(idx, "_" + key)) for key in names}
    for key, v in zip(("tail_codes", "tail_coarse", "tail_dsq", "tail_ids"),
                      tail):
        out[key] = np.asarray(v)
    return out


def test_build_from_codes_matches_reference(ivf_setup):
    *_, jidx, idx, _ = ivf_setup
    got = _arrays(idx, idx._tail)
    want = _arrays(jidx, (jidx._tail_codes, jidx._tail_coarse,
                          jidx._tail_dsq, jidx._tail_ids))
    for key, v in want.items():
        assert got[key].dtype == v.dtype, key
        np.testing.assert_array_equal(got[key], v, err_msg=key)
    assert (idx._pg_dsq_min, idx._pg_lp, idx._pg_seg) == (
        jidx._pg_dsq_min, jidx._pg_lp, jidx._pg_seg)
    assert (idx.ntotal, idx.n_groups) == (jidx.ntotal, jidx.n_groups)
    assert 0 < idx.tail_len < idx.ntotal


def _near_tie(x, cands, a, b):
    """|d(x, cands[a]) - d(x, cands[b])| <= 1e-4 relative, in float64."""
    d = ((x[None, :] - cands[[a, b]]) ** 2).sum(-1)
    return abs(d[0] - d[1]) <= 1e-4 * max(d.max(), 1.0)


def test_build_encodes_like_reference(ivf_setup):
    base, _, _, jidx, idx, (a, c, _) = ivf_setup
    ta, tc, tdq = (x.numpy() for x in idx.encode_chunk(base))
    x64 = base.astype(np.float64)
    cent = np.asarray(jidx.centroids, np.float64)
    for r in np.nonzero(ta != a)[0]:
        assert _near_tie(x64[r], cent, ta[r], a[r]), r
    assert (ta == a).mean() >= 0.999
    same = ta == a
    cb = np.asarray(jidx.pq.codebooks, np.float64)
    ds = cb.shape[2]
    for r, mm in zip(*np.nonzero((tc != c) & same[:, None])):
        resid = (x64[r] - cent[a[r]])[mm * ds:(mm + 1) * ds]
        assert _near_tie(resid, cb[mm], tc[r, mm], c[r, mm]), (r, mm)
    assert np.all(tc == c, axis=1)[same].mean() >= 0.999
    ok = same & np.all(tc == c, axis=1)
    np.testing.assert_allclose(tdq[ok], np.asarray(
        jidx.encode_chunk(base)[2])[ok], rtol=1e-5)
    # build() lays out what encode_chunk gives
    full = ivf_adc_from_numpy(np.asarray(jidx.centroids),
                              np.asarray(jidx.pq.codebooks), bucket_cap=96)
    full.ENC_CHUNK = 1500                      # several chunks
    full.build(base)
    assert full.ntotal == base.shape[0]
    ref = ivf_adc_from_numpy(np.asarray(jidx.centroids),
                             np.asarray(jidx.pq.codebooks), bucket_cap=96)
    ref.build_from_codes(ta, tc, tdq)
    np.testing.assert_array_equal(full._buckets.numpy(),
                                  ref._buckets.numpy())
    np.testing.assert_array_equal(full._pg_dec8_t.numpy(),
                                  ref._pg_dec8_t.numpy())


@pytest.mark.parametrize("engine", [
    "search", "search_probe_chunk", "search_fast", "search_fast_union",
    "search_threshold", "search_grouped"])
def test_engines_match_reference(ivf_setup, engine):
    _, queries, _, jidx, idx, _ = ivf_setup
    q = queries[:32]
    if engine == "search":
        got, want = idx.search(q, 10, nprobe=8), jidx.search(q, 10, nprobe=8)
    elif engine == "search_probe_chunk":
        got = idx.search(q, 10, nprobe=12, probe_chunk=5)
        want = jidx.search(q, 10, nprobe=12, probe_chunk=5)
        whole = idx.search(q, 10, nprobe=12)
        np.testing.assert_array_equal(got[1].numpy(), whole[1].numpy())
    elif engine.startswith("search_fast"):
        ex = engine == "search_fast"
        got = idx.search_fast(q, 10, nprobe=8, exact_probe=ex)
        want = jidx.search_fast(q, 10, nprobe=8, exact_probe=ex)
        assert int(got[2]) == int(want[2]) == 0
        got, want = got[:2], want[:2]
    elif engine == "search_threshold":
        radius = float(np.median(np.asarray(jidx.search(q, 32)[0])[:, 5]))
        d, i, valid, count = idx.search_threshold(q, radius, nprobe=16,
                                                  max_results=64)
        jd, ji, jvalid, jcount = map(np.asarray, jidx.search_threshold(
            q, radius, nprobe=16, max_results=64))
        np.testing.assert_array_equal(count.numpy(), jcount)
        np.testing.assert_array_equal(valid.numpy(), jvalid)
        got, want = (d, i), (jd, ji)
    else:
        gd, gi, mi = idx.search_grouped(q, 5, nprobe=16)
        jgd, jgi, jmi = map(np.asarray, jidx.search_grouped(q, 5,
                                                            nprobe=16))
        assert_ids_match(gd.numpy(), mi.numpy(), jgd, jmi)
        got, want = (gd, gi), (jgd, jgi)
    assert_ids_match(got[0].numpy(), got[1].numpy(), *map(np.asarray, want))


def test_save_load_both_directions(ivf_setup, tmp_path):
    _, queries, _, jidx, idx, _ = ivf_setup
    idx.save(str(tmp_path / "port.npz"))
    jidx.save(str(tmp_path / "jax.npz"))
    zp, zj = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert set(zp.files) == set(zj.files)
    for key in zp.files:
        assert zp[key].dtype == zj[key].dtype, key
        np.testing.assert_array_equal(zp[key], zj[key], err_msg=key)
    q = queries[:16]
    back = JIVFADCIndex.load(str(tmp_path / "port.npz"))
    loaded = IVFADCIndex.load(str(tmp_path / "jax.npz"))
    for a, b in ((loaded.search(q, 10), jidx.search(q, 10)),
                 (loaded.search_fast(q, 10)[:2], back.search_fast(q, 10)[:2]),
                 (loaded.search_grouped(q, 5)[:2],
                  back.search_grouped(q, 5)[:2])):
        assert_ids_match(a[0].numpy(), a[1].numpy(), *map(np.asarray, b))


def test_port_train_reaches_reference_recall(sift_like):
    """The port's own train at tests/test_adc_index.py's settings, held to
    its bars (recall@10 > 0.8 at full probe, > 0.55 at nprobe 8) on the
    mean over seeds 0-4: the 0.8 bar sits at this configuration's expected
    recall (cvt_tpu itself gives 0.78-0.83 over keys 0-4 on 64 queries),
    so a single seed passes or fails by chance. search_fast is held to
    search on each index."""
    base, queries = sift_like
    exact = JFlatIndex(base.shape[1], "l2", chunk=4096)
    exact.add(base)
    gt = np.asarray(exact.search(queries, 1)[1])[:, 0]
    r_full, r8 = [], []
    for seed in range(5):
        idx = IVFADCIndex(coarse_k=64, m=8, k=64)
        idx.train(torch.Generator().manual_seed(seed), base[:2048],
                  coarse_iters=6, pq_iters=6)
        idx.build(base)
        assert idx.ntotal == base.shape[0]
        r_full.append(recall_at_k(idx.search(queries, 10, nprobe=64)[1], gt,
                                  k=10))
        _, ids_8 = idx.search(queries, 10, nprobe=8)
        r8.append(recall_at_k(ids_8, gt, k=10))
        d_f, i_f, dropped = idx.search_fast(queries, 10, nprobe=8)
        assert int(dropped) == 0
        assert abs(recall_at_k(i_f, gt, k=10) - r8[-1]) <= 0.05
        for rows in (ids_8.numpy(), i_f.numpy()):
            for r in rows:
                v = r[r >= 0]
                assert len(np.unique(v)) == len(v)
    assert np.mean(r_full) > 0.8, r_full
    assert np.mean(r8) > 0.55, r8


def test_index_api_edges(sift_like):
    base, queries = sift_like
    idx = IVFADCIndex(coarse_k=8, m=8, k=16)
    with pytest.raises(RuntimeError):
        idx.build(base[:100])
    idx.train(torch.Generator().manual_seed(0), base[:512], coarse_iters=2,
              pq_iters=2, sample=256)
    assert idx.centroids.shape == (8, 128)
    with pytest.raises(RuntimeError):
        idx.search(queries[:2], 1)
    idx.build(base[:300])
    with pytest.raises(RuntimeError):
        idx.search_grouped(queries[:2], 1)
    d, i, _ = idx.search_fast(queries[:3], 10, nprobe=50)   # nprobe clipped
    assert i.shape == (3, 10) and int(i.max()) < 300
    assert np.isfinite(d.numpy()[i.numpy() >= 0]).all()
    with pytest.raises(ValueError):
        idx.build_from_codes(np.zeros(4, np.int32), np.zeros((4, 8)),
                             np.zeros(4), group_ids=np.zeros(3))
