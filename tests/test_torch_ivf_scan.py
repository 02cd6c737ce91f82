"""cvt_tpu_torch.ops.kernels.ivf_scan held against cvt_tpu's Pallas
ivf_scan, the Pallas kernel run with interpret=True on the CPU.

On the CPU the kernel wrapper runs its plain PyTorch twin, so these tests
hold the twin (and everything around it) against the TPU kernel.
Tolerances:
  * integer stages bitwise: _ivf_pack_caps, segpack (the twin on a
    per-cell table cipc and seg_cell against the Pallas kernel on the same
    q2s, qs, cache, norms and sel, and the [S*spt, B] cip that cvt_tpu's
    kernel takes, expanded from cipc through seg_cell; with a live count
    n_live, its live slots against the Pallas kernel's and its fill slots
    INT32_MAX), every array of build_page_layout;
  * ivf_union_search: distances rtol 1e-5 (the coarse products and the
    rescore sum in another order), ids equal except at near-ties (another
    entry of the reference's row within 1e-4 relative of that distance, or
    the last slot), n_dropped equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.index import IVFADCIndex as JIVFADCIndex
from cvt_tpu.ops.pallas import ivf_scan as J
from cvt_tpu_torch.ops.kernels import _build
from cvt_tpu_torch.ops.kernels import ivf_scan as T

t = torch.from_numpy
LP, SEG = 512, 32
SPT = LP // SEG


def assert_ids_match(d, i, jd, ji, rel=1e-4):
    """Distances rtol 1e-5; an id may differ from the reference's only
    where the reference's row holds another distance within `rel` of that
    slot's (a near-tie the two packages may order either way) or at the
    last slot (a near-tie with the first entry past k)."""
    d, i, jd, ji = map(np.asarray, (d, i, jd, ji))
    np.testing.assert_allclose(d, jd, rtol=1e-5)
    k = ji.shape[1]
    for r, c in zip(*np.nonzero(i != ji)):
        if c == k - 1:
            continue
        gap = np.abs(np.delete(jd[r], c) - jd[r, c])
        assert gap.min() <= rel * max(abs(jd[r, c]), 1.0), (r, c)


KC = 10


def _page_inputs(d, b, seed):
    """Seeded arguments of the page scan over 6 pages: BIG pad rows, a
    page of pad rows only, KC cells in cell order over the segments, dead
    segments and a page of them (page 1, a fully masked slot), BIG-masked
    cipc entries and a cell masked for every query, and a repeated fill
    page in sel."""
    rng = np.random.default_rng(seed)
    nvcap, marker = J._ivf_pack_caps(SEG, d)
    ipb = 127 * 127 * d
    n_pages = 6
    bpad = -(-b // 128) * 128
    qs = np.float32(rng.uniform(0.5, 2.0))
    dec8_t = rng.integers(-127, 128, (d, n_pages * LP)).astype(np.int8)
    nrm = rng.uniform(0, 0.9 * nvcap * qs, n_pages * LP).astype(np.float32)
    nrm[rng.random(nrm.shape) < 0.1] = J.BIG
    nrm[4 * LP:5 * LP] = J.BIG                        # a page of pad rows
    seg_cell = np.sort(rng.integers(0, KC, n_pages * SPT)).astype(np.int32)
    seg_cell[rng.random(seg_cell.shape) < 0.1] = -1   # dead segments
    seg_cell[SPT:2 * SPT] = -1                        # a page of them
    sel = np.array([3, 4, 0, 5, 1, 0, 0], np.int32)   # fill slots: page 0
    cipc = rng.uniform(0, 0.9 * ipb * qs, (KC, bpad)).astype(np.float32)
    cipc[rng.random(cipc.shape) < 0.3] = J.BIG
    cipc[int(seg_cell[3 * SPT])] = J.BIG              # a cell no query probed
    cipc[:, b:] = J.BIG                               # padded query columns
    q2s = rng.integers(-127, 128, (bpad, d)).astype(np.int8)
    q2s[b:] = 0
    return q2s, qs, dec8_t, nrm[:, None], cipc, seg_cell, sel


def _expand(cipc, seg_cell, sel):
    """The [S*spt, Bpad] per-segment cip of cvt_tpu's kernel: each
    selected segment's cell row of cipc, BIG for a dead segment."""
    cells = seg_cell[(sel[:, None] * SPT + np.arange(SPT)).reshape(-1)]
    return np.where(cells[:, None] >= 0, cipc[np.maximum(cells, 0)],
                    np.float32(J.BIG)).astype(np.float32)


def test_pack_caps_match_reference():
    for d in (64, 128):
        assert T._ivf_pack_caps(SEG, d) == J._ivf_pack_caps(SEG, d)
    nvcap, marker = T._ivf_pack_caps(SEG, 128)
    assert (nvcap, marker) == (26_328_606, 32_522_143)
    assert T._marker_f32(marker) == 32_522_144.0
    with pytest.raises(ValueError):
        T._ivf_pack_caps(4096, 1024)


@pytest.mark.parametrize("d,b", [(64, 128), (64, 200), (128, 128),
                                 (128, 200)])
def test_segmin_twin_matches_pallas_kernel(d, b):
    q2s, qs, dec8_t, nrm_col, cipc, seg_cell, sel = _page_inputs(
        d, b, seed=d + b)
    cip = _expand(cipc, seg_cell, sel)
    want = np.asarray(J._ivf_pages_segmin(
        jnp.asarray(q2s), jnp.float32(qs), jnp.asarray(dec8_t),
        jnp.asarray(nrm_col), jnp.asarray(cip), jnp.asarray(sel), LP, SEG,
        True))
    got = T.ivf_pages_segmin(t(q2s), torch.tensor([qs]), t(dec8_t),
                             t(nrm_col), t(cipc), t(seg_cell), t(sel), LP,
                             SEG).numpy()
    np.testing.assert_array_equal(got, want)
    # cvt_tpu hands its kernel cip [S*spt, B] unpadded: the real columns
    # agree with the padded call
    narrow = np.asarray(J._ivf_pages_segmin(
        jnp.asarray(q2s), jnp.float32(qs), jnp.asarray(dec8_t),
        jnp.asarray(nrm_col), jnp.asarray(cip[:, :b]), jnp.asarray(sel), LP,
        SEG, True))
    np.testing.assert_array_equal(got[:, :b], narrow[:, :b])
    # the pad page under masked cip carries both float32 markers
    _, marker = T._ivf_pack_caps(SEG, d)
    mk = int(np.float32(marker))
    ip = q2s.astype(np.int64) @ dec8_t[:, 4 * LP:5 * LP].astype(np.int64)
    keys = (ip + 2 * mk) * SEG + np.arange(LP) % SEG          # [Bpad, LP]
    top = keys.reshape(-1, SPT, SEG).min(2).T                  # [SPT, Bpad]
    masked = cip[SPT:2 * SPT] >= J.BIG / 2
    np.testing.assert_array_equal(got[SPT:2 * SPT][masked], top[masked])
    assert got.max() < 2 ** 31 - 1


@pytest.mark.parametrize("n_live", [0, 1, 6, 7])      # S = 7
def test_segmin_twin_skips_fill_slots(n_live):
    """Slots past n_live are fill slots: the twin writes INT32_MAX there
    and the Pallas kernel's keys in every live slot. A page id out of
    range (negative or past the cache) reads nothing either."""
    d, b = 64, 200
    q2s, qs, dec8_t, nrm_col, cipc, seg_cell, sel = _page_inputs(
        d, b, seed=n_live)
    want = np.asarray(J._ivf_pages_segmin(
        jnp.asarray(q2s), jnp.float32(qs), jnp.asarray(dec8_t),
        jnp.asarray(nrm_col), jnp.asarray(_expand(cipc, seg_cell, sel)),
        jnp.asarray(sel), LP, SEG, True))
    args = [t(q2s), torch.tensor([qs]), t(dec8_t), t(nrm_col), t(cipc),
            t(seg_cell), t(sel), LP, SEG,
            torch.tensor([n_live], dtype=torch.int32)]
    got = T.ivf_pages_segmin(*args).numpy()
    live = n_live * SPT
    np.testing.assert_array_equal(got[:live], want[:live])
    assert (got[live:] == T.I32_MAX).all()
    args[6] = t(np.array([3, -1, 0, 6, 1, 0, 0], np.int32))
    off = T.ivf_pages_segmin(*args).numpy()
    bad = np.repeat(np.array([0, 1, 0, 1, 0, 0, 0], bool), SPT)
    assert (off[bad] == T.I32_MAX).all()
    np.testing.assert_array_equal(off[~bad], got[~bad])


@pytest.mark.parametrize("d,nst,smem,fits", [
    (32, 3, 42_496, True), (128, 3, 42_496, True),
    (512, 3, 165_376, True), (896, 3, 288_256, False),
    (896, 2, 230_912, True), (900, 2, 263_680, False),
    (1024, 2, 263_680, False)])
def test_page_smem_budget(d, nst, smem, fits):
    """The ivf_page block must fit sm_90's 227 KB opt-in with at least two
    query tiles in its ring: D up to 896 (two tiles past D = 640). The
    wrapper refuses a larger D before launch."""
    assert T._page_smem_bytes(d, nst) == smem
    assert (smem <= T.SMEM_LIMIT) == fits
    if nst == 3:
        return
    q2s = torch.zeros((128, d), dtype=torch.int8)
    args = (q2s, torch.ones(1), torch.zeros((d, LP), dtype=torch.int8),
            torch.zeros((LP, 1)), torch.zeros((1, 128)),
            torch.zeros(LP // 16, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32), LP, 16,
            torch.ones(1, dtype=torch.int32))
    if fits:
        T._check_launch(*args)
    else:
        with pytest.raises(ValueError, match="227 KB"):
            T._check_launch(*args)


def test_page_layout_matches_reference():
    rng = np.random.default_rng(0)
    n, m, k, ds, kc = 3000, 8, 32, 16, 40
    assign = rng.integers(0, kc, n)
    assign[assign == 7] = 8                          # an empty cell
    codes = rng.integers(0, k, (n, m)).astype(np.uint8)
    dsq = rng.uniform(1e4, 1e5, n).astype(np.float32)
    cb = rng.normal(0, 20, (m, k, ds)).astype(np.float32)
    got = T.build_page_layout(codes, assign, dsq, cb)
    want = J.build_page_layout(codes, assign, dsq, cb)
    assert set(got) == set(want)
    for key, v in want.items():
        if isinstance(v, (int, float)):
            assert got[key] == v, key
        else:
            v = np.asarray(v)
            assert got[key].dtype == v.dtype, key
            np.testing.assert_array_equal(got[key], v, err_msg=key)


@pytest.fixture(scope="module")
def ivf_layout(sift_like):
    """A small cvt_tpu IVF index and its page layout."""
    import jax
    base, queries = sift_like
    idx = JIVFADCIndex(coarse_k=32, m=8, k=32)
    idx.train(jax.random.key(0), base[:2048], coarse_iters=4, pq_iters=4)
    a, c, dq = map(np.array, idx.encode_chunk(base))
    return idx, queries, a, c, dq


def _search_both(idx, q, a, c, dq, n, **kw):
    pg = J.build_page_layout(c[:n], a[:n], dq[:n],
                             np.asarray(idx.pq.codebooks))
    args = [np.array(pg[key]) for key in ("dec8_t", "dec16", "srow16",
                                          "nrm_col", "seg_cell", "rowids",
                                          "srow")]
    cent = np.array(idx.centroids)
    jd, ji, jdrop = J.ivf_union_search(
        jnp.asarray(q), jnp.asarray(cent), *map(jnp.asarray, args),
        pg["dsq_min"], interpret=True, **kw)
    d, i, drop = T.ivf_union_search(t(q), t(cent), *map(t, args),
                                    pg["dsq_min"], **kw)
    return (d, i, drop), (jd, ji, jdrop)


@pytest.mark.parametrize("n,k,nprobe,max_pages,exact_probe", [
    (4096, 10, 8, 64, True),
    (4096, 10, 8, 64, False),
    (4096, 10, 16, 2, True),          # pages past max_pages are dropped
    (40, 600, 4, 8, True),            # one page: the pool (512) < k
    (4096, 1, 4, 64, True),
    (4096, 100, 8, 64, True),         # k + slack 106: above 64
    (4096, 100, 16, 64, False),
    (4096, 30, 32, 64, True),         # every cell probed
    (2048, 20, 4, 64, False),
])
def test_union_search_matches_reference(ivf_layout, n, k, nprobe,
                                        max_pages, exact_probe):
    idx, queries, a, c, dq = ivf_layout
    (d, i, drop), (jd, ji, jdrop) = _search_both(
        idx, queries[:40], a, c, dq, n, nprobe=nprobe, k=k,
        max_pages=max_pages, exact_probe=exact_probe)
    assert d.shape == i.shape == (40, k)
    assert int(drop) == int(jdrop)
    assert (int(drop) > 0) == (max_pages == 2)
    assert_ids_match(d.numpy(), i.numpy(), jd, ji)
    if n < k:
        assert (i.numpy()[:, n:] == -1).all()


def test_cpu_wrapper_runs_twin_without_building(monkeypatch):
    """On the CPU the wrapper takes the twin because the tensors lie on
    the CPU: no build, no launch, no count. Other devices raise."""
    def refuse():
        raise AssertionError("the CPU path must not load the kernels")
    monkeypatch.setattr(_build, "load", refuse)
    before = T.ivf_pages_segmin.launches
    q2s, qs, dec8_t, nrm_col, cipc, seg_cell, sel = map(
        lambda a: torch.as_tensor(np.asarray(a)), _page_inputs(64, 128, 0))
    T.ivf_pages_segmin(q2s, qs.reshape(1), dec8_t, nrm_col, cipc, seg_cell,
                       sel, LP, SEG)
    assert T.ivf_pages_segmin.launches == before
    with pytest.raises(ValueError):
        T.ivf_pages_segmin(q2s.to("meta"), qs.reshape(1), dec8_t, nrm_col,
                           cipc, seg_cell, sel, LP, SEG)
    assert any(s.endswith("ivf_scan.cu") for s in _build._sources())
    assert T.ivf_pages_segmin.symbol == "cvt_ivf_pages_segmin"
    assert len(T.ivf_pages_segmin.argtypes) == 18
