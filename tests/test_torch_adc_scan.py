"""cvt_tpu_torch.ops.kernels.adc_scan held against cvt_tpu's Pallas
adc_scan, the Pallas kernels run with interpret=True on the CPU.

On the CPU the kernel wrappers run their plain PyTorch twins, so these
tests hold the twins (and everything around the kernels) against the TPU
kernels. Tolerances:
  * integer stages bitwise: _pack_caps, _quantize_codebooks (vs
    _group_codebooks), _fold_queries -> q2s, segpack and tiletop rows 0-3
    (rows 4-7 are padding the TPU kernel never writes), fast-path ids;
  * f32 distances rtol 1e-5.
The in-kernel norm is a float32 sum, and its order decides round(norm/qs)
for about 1% of rows. Most segmin tests take s2 from {1/4, 1/2, 1, 2},
where every partial sum is exact in float32 in any order; one takes the
real scales (s2 = srow^2) to hold the twin to the Pallas kernel's own
summation order. Each first asserts that no row's norm/qs lies within
1e-4 of a half-integer, so that exact equality is a fair demand."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.ops.pallas import adc_scan as J
from cvt_tpu_torch.ops.kernels import _build
from cvt_tpu_torch.ops.kernels import adc_scan as T

t = torch.from_numpy
M, K, DS = 8, 64, 16
D = M * DS


def _half_gap(norm, qs) -> float:
    """Smallest distance of any row's norm/qs (float64) to a half-integer."""
    x = np.asarray(norm, np.float64) / float(qs)
    return float(np.min(np.abs(x - np.floor(x) - 0.5)))


@pytest.fixture(scope="module")
def setup():
    # the first seed whose rows all keep norm/qs more than 1e-4 away from
    # a half-integer (about half of all seeds at 4096 rows)
    for seed in range(100):
        rng = np.random.default_rng(seed)
        cb = rng.normal(0, 20, size=(M, K, DS)).astype(np.float32)
        q = rng.normal(0, 50, size=(64, D)).astype(np.float32)
        codes = rng.integers(0, K, size=(4096, M)).astype(np.uint8)
        s2 = rng.choice(np.array([0.25, 0.5, 1.0, 2.0], np.float32), size=D)
        cb_q, srow = T._quantize_codebooks(t(cb))
        _, qs = T._fold_queries(t(q), srow,
                                127.0 ** 2 * torch.sum(srow * srow),
                                J._pack_caps(128, D)[0])
        dec = T.decode_int8(t(codes), cb_q).numpy().astype(np.float64)
        if _half_gap(dec ** 2 @ s2, qs) > 1e-4:
            break
    cbt, _, group = J._group_codebooks(cb)
    return dict(cb=cb, q=q, codes=codes, s2=s2, cbt=cbt, srow=srow,
                group=group, cb_q=cb_q)


def _fold_both(q, srow):
    vcap, _ = J._pack_caps(128, D)
    q2s, qs = J._fold_queries(jnp.asarray(q), jnp.asarray(srow.numpy()),
                              127.0 ** 2 * jnp.sum(jnp.square(
                                  jnp.asarray(srow.numpy()))), vcap)
    tq2s, tqs = T._fold_queries(t(q), srow,
                                127.0 ** 2 * torch.sum(srow * srow), vcap)
    return (q2s, qs), (tq2s, tqs)


def test_pack_caps_and_unpack():
    for seg, d in ((128, 128), (64, 256), (128, 64)):
        assert T._pack_caps(seg, d) == J._pack_caps(seg, d)
    with pytest.raises(ValueError):
        T._pack_caps(4096, 1024)
    keys = np.array([-70000, -129, -128, -1, 0, 1, 127, 128, 2 ** 30],
                    np.int32)
    s, lane = T._unpack(t(keys), 128)
    js, jl = J._unpack(jnp.asarray(keys), 128)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(lane.numpy(), np.asarray(jl))


def test_quantize_codebooks_matches_group_codebooks(setup):
    cbt = np.asarray(setup["cbt"])
    g = setup["group"]
    for mm in range(M):
        gi, j = divmod(mm, g)
        np.testing.assert_array_equal(
            cbt[gi, j * DS:(j + 1) * DS, j * K:(j + 1) * K],
            setup["cb_q"][mm].numpy().T)
    _, srow_j, _ = J._group_codebooks(setup["cb"])
    np.testing.assert_array_equal(setup["srow"].numpy(), np.asarray(srow_j))


@pytest.mark.parametrize("b", [64, 200])
def test_fold_queries_bitwise(setup, b):
    q = np.random.default_rng(b).normal(0, 50, (b, D)).astype(np.float32)
    (q2s, qs), (tq2s, tqs) = _fold_both(q, setup["srow"])
    assert tq2s.shape == (256 if b == 200 else 128, D)
    np.testing.assert_array_equal(tq2s.numpy(), np.asarray(q2s))
    assert np.float32(qs) == tqs.numpy()
    # without the norm cap, and with a cap that binds
    q2s, qs = J._fold_queries(jnp.asarray(q), jnp.asarray(setup["srow"]))
    tq2s, tqs = T._fold_queries(t(q), setup["srow"])
    np.testing.assert_array_equal(tq2s.numpy(), np.asarray(q2s))
    q2s, qs = J._fold_queries(jnp.asarray(q), jnp.asarray(setup["srow"]),
                              jnp.float32(1e9), 1000)
    tq2s, tqs = T._fold_queries(t(q), setup["srow"],
                                torch.tensor(1e9), 1000)
    np.testing.assert_array_equal(tq2s.numpy(), np.asarray(q2s))
    assert np.float32(qs) == tqs.numpy()


@pytest.mark.parametrize("tile_n,n_valid", [(1024, 4096), (2048, 3000),
                                            (1024, 1500)])
def test_segmin_twin_matches_pallas_kernel(setup, tile_n, n_valid):
    (q2s, qs), (tq2s, tqs) = _fold_both(setup["q"], setup["srow"])
    dec = T.decode_int8(t(setup["codes"]), setup["cb_q"]).numpy()
    assert _half_gap((dec.astype(np.float64) ** 2) @ setup["s2"], qs) > 1e-4
    codes_t = jnp.asarray(setup["codes"].astype(np.int32).T)
    sp, tt = J._adc_segmin(q2s, qs, codes_t, setup["cbt"],
                           jnp.asarray(setup["s2"][:, None]), n_valid,
                           tile_n, 128, setup["group"], True)
    tsp, ttt = T.adc_segmin(tq2s, tqs, t(setup["codes"]), setup["cb_q"],
                            t(setup["s2"]), n_valid, tile_n)
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(sp))
    np.testing.assert_array_equal(ttt[:, :4].numpy(), np.asarray(tt)[:, :4])
    assert not ttt[:, 4:].any()


def test_segmin_twin_sums_norms_in_pallas_order():
    """With the real per-dimension scales the float32 norm depends on the
    order of its sum; the twin follows the Pallas kernel's, so segpack and
    tiletop still agree bit for bit."""
    vcap, _ = J._pack_caps(128, D)
    for seed in range(100):
        rng = np.random.default_rng(seed)
        cb = rng.normal(0, 20, size=(M, K, DS)).astype(np.float32)
        q = rng.normal(0, 50, size=(64, D)).astype(np.float32)
        codes = rng.integers(0, K, size=(4096, M)).astype(np.uint8)
        cb_q, srow = T._quantize_codebooks(t(cb))
        s2 = srow * srow
        tq2s, tqs = T._fold_for(t(q), srow, D)
        dec = T.decode_int8(t(codes), cb_q).double()
        if _half_gap((dec ** 2 @ s2.double()).numpy(), tqs) > 1e-4:
            break
    jsrow = jnp.asarray(srow.numpy())
    q2s, qs = J._fold_queries(jnp.asarray(q), jsrow,
                              127.0 ** 2 * jnp.sum(jsrow * jsrow), vcap)
    cbt, _, group = J._group_codebooks(cb)
    sp, tt = J._adc_segmin(q2s, qs, jnp.asarray(codes.astype(np.int32).T),
                           cbt, jnp.asarray(s2.numpy()[:, None]), 4096, 1024,
                           128, group, True)
    tsp, ttt = T.adc_segmin(tq2s, tqs, t(codes), cb_q, s2, 4096, 1024)
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(sp))
    np.testing.assert_array_equal(ttt[:, :4].numpy(), np.asarray(tt)[:, :4])


def test_segmin_cached_twin_matches_pallas_kernel(setup):
    (q2s, qs), (tq2s, tqs) = _fold_both(setup["q"], setup["srow"])
    dec = T.decode_int8(t(setup["codes"]), setup["cb_q"])
    dec8_t = dec.T.contiguous()
    norm = np.random.default_rng(1).uniform(0, 2e5, 4096).astype(np.float32)
    # move rows off the half-integers of norm/qs
    x = norm.astype(np.float64) / float(qs)
    norm[np.abs(x - np.floor(x) - 0.5) < 1e-3] += np.float32(0.01 * qs)
    norm = norm[:, None]
    assert _half_gap(norm[:, 0], qs) > 1e-4
    sp, tt = J._adc_segmin_cached(q2s, qs, jnp.asarray(dec8_t.numpy()),
                                  jnp.asarray(norm), 3500, 1024, 128, True)
    tsp, ttt = T.adc_segmin_cached(tq2s, tqs, dec8_t, t(norm), 3500, 1024)
    np.testing.assert_array_equal(tsp.numpy(), np.asarray(sp))
    np.testing.assert_array_equal(ttt[:, :4].numpy(), np.asarray(tt)[:, :4])


@pytest.mark.parametrize("n_valid,k", [(4096, 10), (600, 10), (4096, 1)])
def test_select_tiletop_matches_reference(setup, n_valid, k):
    (_, qs), (tq2s, tqs) = _fold_both(setup["q"], setup["srow"])
    tsp, ttt = T.adc_segmin(tq2s, tqs, t(setup["codes"]), setup["cb_q"],
                            t(setup["s2"]), n_valid, 1024)
    q_sq = np.sum(setup["q"] ** 2, -1)
    d, i = T._select_tiletop(tsp, ttt, tqs, t(q_sq), 64, k, 1024, 128,
                             n_valid)
    jd, ji = J._select_tiletop(jnp.asarray(tsp.numpy()),
                               jnp.asarray(ttt.numpy()), qs,
                               jnp.asarray(q_sq), 64, k, 1024, 128, n_valid)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)


def test_rescore_segments_matches_reference(setup):
    rng = np.random.default_rng(3)
    codes = setup["codes"]
    dec_sq = rng.uniform(0, 1e4, 4096).astype(np.float32)
    seg_ids = np.stack([rng.permutation(32)[:6] for _ in range(16)])
    q = setup["q"][:16]
    q_sq = np.sum(q ** 2, -1)
    d, i = T._rescore_segments(t(q), t(q_sq), t(seg_ids), t(codes),
                               t(dec_sq), t(setup["cb"]), 10, 128, 4000)
    jd, ji = J._rescore_segments(jnp.asarray(q), jnp.asarray(q_sq),
                                 jnp.asarray(seg_ids), jnp.asarray(codes),
                                 jnp.asarray(dec_sq),
                                 jnp.asarray(setup["cb"]), 10, 128, 4000)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)


@pytest.mark.parametrize("exact", [False, True])
def test_adc_search_ids_match_reference(setup, exact):
    codes = setup["codes"]
    cbn = (setup["cb"] ** 2).sum(-1)
    dec_sq = cbn[np.arange(M)[None, :], codes].sum(-1).astype(np.float32)
    q = setup["q"][:32]
    jd, ji = J.adc_search(jnp.asarray(q), None, jnp.asarray(codes),
                          jnp.asarray(dec_sq), jnp.asarray(setup["cb"]), 10,
                          4000, exact=exact, interpret=True)
    d, i = T.adc_search(t(q), None, t(codes), t(dec_sq), t(setup["cb"]),
                        10, 4000, exact=exact)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)
    with pytest.raises(ValueError):
        T.adc_search(t(q), None, t(codes[:4000]), t(dec_sq), t(setup["cb"]),
                     10, 4000)
    with pytest.raises(ValueError):
        T.adc_search(t(q), None, t(codes), t(dec_sq), t(setup["cb"]), 129,
                     4000)


def test_adc_search_cached_ids_match_reference(setup):
    dec = T.decode_int8(t(setup["codes"]), setup["cb_q"])
    srow = setup["srow"]
    norm = torch.sum((dec.float() * srow) ** 2, 1)
    dec8_t = dec.T.contiguous()
    q = setup["q"][:16]
    jd, ji = J.adc_search_cached(jnp.asarray(q), jnp.asarray(dec8_t.numpy()),
                                 jnp.asarray(norm[:, None].numpy()),
                                 jnp.asarray(srow.numpy()), 10, 4000,
                                 interpret=True)
    d, i = T.adc_search_cached(t(q), dec8_t, norm[:, None], srow, 10, 4000)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)


def test_cpu_wrappers_run_twins_without_building(setup, monkeypatch):
    """On the CPU the wrappers take the twins because the tensors lie on
    the CPU: no build, no launch, no count. Other devices raise."""
    def refuse():
        raise AssertionError("the CPU path must not load the kernels")
    monkeypatch.setattr(_build, "load", refuse)
    before = T.adc_segmin.launches, T.adc_segmin_cached.launches
    (_, _), (tq2s, tqs) = _fold_both(setup["q"], setup["srow"])
    T.adc_segmin(tq2s, tqs, t(setup["codes"]), setup["cb_q"],
                 t(setup["s2"]), 4096, 1024)
    dec8_t = T.decode_int8(t(setup["codes"]), setup["cb_q"]).T.contiguous()
    T.adc_segmin_cached(tq2s, tqs, dec8_t, torch.ones(4096, 1), 4096, 1024)
    assert (T.adc_segmin.launches, T.adc_segmin_cached.launches) == before
    meta = tq2s.to("meta")
    with pytest.raises(ValueError):
        T.adc_segmin(meta, tqs, t(setup["codes"]), setup["cb_q"],
                     t(setup["s2"]), 4096, 1024)
    with pytest.raises(ValueError):
        T.adc_segmin_cached(meta, tqs, dec8_t, torch.ones(4096, 1), 4096,
                            1024)


def test_decode_int8_out_of_range_codes_decode_to_zero(setup):
    codes = np.array([[0] * M, [K - 1] * M, [K] * M, [255] * M], np.uint8)
    dec = T.decode_int8(t(codes), setup["cb_q"]).numpy()
    assert not dec[2:].any()
    np.testing.assert_array_equal(dec[1].reshape(M, DS),
                                  setup["cb_q"][:, K - 1].numpy())


def test_build_paths_are_in_the_package():
    path = _build.library_path()
    assert path.startswith(_build.BUILD_DIR)
    assert path == _build.library_path()
    assert any(s.endswith("adc_scan.cu") for s in _build._sources())
