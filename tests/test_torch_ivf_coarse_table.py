"""`ivf_union_search`'s per-cell coarse terms against the per-segment form
they replace.

The search hands the `ivf_page` kernel one table cipc [Kc, Bpad] that the
kernel reads through seg_cell. The former form was a [S*spt, B] matrix
with a row for every selected segment, built from a second product of the
queries with each segment's centroid. Here both start from the same
coarse products: queries and centroids hold small integers, so every
product is exact in any order. Rebuilt from `coarse_ip`, the former
matrix gives the former qs, q2s and (through cvt_tpu's Pallas kernel, run
with interpret=True) the former segpack; the new search must give each of
them bit for bit, the fill slots INT32_MAX where the former kernel scanned
them under masked terms.

The layout puts two cells on page 0 that no query probes: one has the
batch's largest inner products (so c0, taken over every selected page's
cells, fill slots included, takes its term) and one the smallest (so a
largest term taken over more than the live slots' cells would clamp qs).
The last page holds dead segments, one more is made dead mid-page, and B
is not a multiple of 128.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvt_tpu.ops.pallas import ivf_scan as J
from cvt_tpu_torch.ops.kernels import recorded_args
from cvt_tpu_torch.ops.kernels import ivf_scan as T
from cvt_tpu_torch.ops.kernels.adc_scan import _fold_queries

LP, SEG = 512, 32
SPT = LP // SEG
D, M, KSUB = 16, 4, 16
KC, B, NPROBE = 12, 40, 3
BIG = T.BIG


def _layout(seed):
    """(q, centroids, page layout) on integer queries and centroids."""
    rng = np.random.default_rng(seed)
    dirn = rng.integers(1, 4, D).astype(np.float32)
    cent = rng.integers(2, 9, (KC, D)).astype(np.float32)  # q >= 0 below
    cent[0] = -20 * dirn                     # least <q, c>: the largest term
    cent[1] = 20 * dirn                      # largest <q, c>: c0's cell
    q = (cent[2 + rng.integers(0, KC - 2, B)]
         + rng.integers(-2, 3, (B, D))).astype(np.float32)
    counts = np.r_[256, 256, rng.integers(100, 700, KC - 2)]
    assign = np.repeat(np.arange(KC), counts)
    n = len(assign)
    codes = rng.integers(0, KSUB, (n, M)).astype(np.uint8)
    cb = rng.normal(0, 1, (M, KSUB, D // M)).astype(np.float32)
    dsq = rng.uniform(10, 100, n).astype(np.float32)
    pg = T.build_page_layout(codes, assign, dsq, cb, lp=LP, seg=SEG)
    pg["seg_cell"][3 * SPT + 5] = -1         # a dead segment mid-page
    cells = pg["seg_cell"]
    assert cells[-1] == -1 and (cells[:SPT] < 2).all()   # page 0: cells 0, 1
    assert not np.isin(cells[SPT:], (0, 1)).any()
    return q, cent, pg


def _former(q, cent, pg, sel, n_live, exact_probe):
    """The former per-segment terms from the same coarse products ->
    (q2s, qs, cipz [S*spt, Bpad])."""
    seg_cell = torch.from_numpy(pg["seg_cell"])
    coarse_ip, _, probes = T.coarse_probes(q, cent, NPROBE)
    probed_bk = torch.zeros((B, KC), dtype=torch.bool)
    probed_bk.scatter_(1, probes, True)
    assert not probed_bk[:, :2].any()        # page 0's cells: fill slots only
    live = torch.arange(sel.shape[0]) < n_live
    sel_segs = sel[:, None].long() * SPT + torch.arange(SPT)
    cells = seg_cell[sel_segs.reshape(-1)]
    cells_c = cells.clamp(0, KC - 1).long()
    cip = -2.0 * coarse_ip[:, cells_c].T                     # [S*spt, B]
    c0 = torch.amin(torch.where(cells[:, None] >= 0, cip, BIG), dim=0)
    cipz = cip - c0[None, :]
    if exact_probe:
        hit = probed_bk[:, cells_c].T & (cells >= 0)[:, None]
        cipz = torch.where(hit, cipz, BIG)
    dead = (cells < 0) | ~live.repeat_interleave(SPT)
    cipz = torch.where(dead[:, None], BIG, cipz)
    nrm_col = torch.from_numpy(pg["nrm_col"])
    srow = torch.from_numpy(pg["srow"])
    nvcap, _ = T._ivf_pack_caps(SEG, D)
    max_nrm = torch.amax(torch.where(nrm_col < BIG / 2, nrm_col, 0.0))

    def fold(max_cip):
        qs_min = torch.maximum(max_nrm / nvcap, max_cip / (127 * 127 * D))
        return _fold_queries(q, srow, qs_min, 1)

    q2s, qs = fold(torch.amax(torch.where(cipz < BIG / 2, cipz, 0.0)))
    # the case bites: page 0's second cell gives c0, and the largest term
    # over every selected cell, fill slots' included, would move qs
    assert bool((c0 == -2.0 * coarse_ip[:, 1]).all())
    wide = torch.amax(torch.where(cells[:, None] >= 0, cip - c0, 0.0))
    assert float(fold(wide)[1]) != float(qs)
    cipz = torch.nn.functional.pad(cipz, (0, q2s.shape[0] - B), value=BIG)
    return q2s, qs, cipz


@pytest.mark.parametrize("exact_probe", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_table_gives_the_former_qs_and_segpack(exact_probe, seed):
    q, cent, pg = _layout(seed)
    q, cent = torch.from_numpy(q), torch.from_numpy(cent)
    keys = ("dec8_t", "dec16", "srow16", "nrm_col", "seg_cell", "rowids",
            "srow")
    arrays = [torch.from_numpy(np.asarray(pg[k])) for k in keys]
    n_pages = pg["dec8_t"].shape[1] // LP
    args = recorded_args("ivf_page", lambda: T.ivf_union_search(
        q, cent, *arrays, pg["dsq_min"], NPROBE, 10, n_pages,
        lp=LP, seg=SEG, exact_probe=exact_probe))
    q2s, qs, dec8_t, nrm_col, cipc, seg_cell, sel, lp, seg, n_live = args
    n_live = int(n_live)
    assert cipc.shape == (KC, 128) and cipc.is_contiguous()
    assert bool((cipc[:, B:] == BIG).all())                  # padded columns
    assert 0 < n_live < sel.shape[0] and int(sel[-1]) == 0   # fill slots

    q2s_f, qs_f, cipz = _former(q, cent, pg, sel, n_live, exact_probe)
    assert qs.reshape(()).numpy().tobytes() == qs_f.numpy().tobytes()
    assert torch.equal(q2s, q2s_f)

    got = T.ivf_pages_segmin(*args).numpy()
    want = np.asarray(J._ivf_pages_segmin(
        jnp.asarray(q2s_f.numpy()), jnp.float32(qs_f.numpy()),
        jnp.asarray(dec8_t.numpy()), jnp.asarray(nrm_col.numpy()),
        jnp.asarray(cipz.numpy()), jnp.asarray(sel.numpy()), LP, SEG, True))
    live = n_live * SPT
    np.testing.assert_array_equal(got[:live], want[:live])
    assert (got[live:] == T.I32_MAX).all()


def test_table_masks_cells_a_query_did_not_probe():
    """With exact_probe, each query's row of cipc is finite at its own
    probed cells only; without, at every cell."""
    q, cent, pg = _layout(2)
    q, cent = torch.from_numpy(q), torch.from_numpy(cent)
    arrays = [torch.from_numpy(np.asarray(pg[k])) for k in (
        "dec8_t", "dec16", "srow16", "nrm_col", "seg_cell", "rowids",
        "srow")]
    _, _, probes = T.coarse_probes(q, cent, NPROBE)
    probed = torch.zeros((B, KC), dtype=torch.bool)
    probed.scatter_(1, probes, True)
    for exact_probe in (True, False):
        args = recorded_args("ivf_page", lambda: T.ivf_union_search(
            q, cent, *arrays, pg["dsq_min"], NPROBE, 10, 64, lp=LP, seg=SEG,
            exact_probe=exact_probe))
        finite = (args[4][:, :B] < BIG / 2).T
        assert torch.equal(finite, probed if exact_probe
                           else torch.ones_like(probed))
