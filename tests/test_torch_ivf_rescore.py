"""Phase 2 of the IVF page scan (`ops.kernels.ivf_scan.ivf_rescore`) on
the CPU, where the wrapper runs its twin `ivf_rescore_plain`: the contract
that `ivf_rescore_kernel` is held to on the card
(tests/test_torch_ivf_rescore_cuda.py), and the wrapper's geometry, checks
and counts. `ivf_union_search`, phase 2 included, is held against cvt_tpu
in tests/test_torch_ivf_scan.py.

Tolerance: none. The contract's cases hold by construction.
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.ops.kernels import _build, recorded_args, wrappers
from cvt_tpu_torch.ops.kernels import ivf_scan as T
from _ivf_rescore_inputs import I32_MAX, positional, rescore_args


def _rows_of(a, seg: int, spt: int, r: int) -> set:
    """The ids of segment row r's rows (slot r // spt of sel)."""
    g = int(a["sel"][r // spt]) * spt + r % spt
    ids = a["rowids"][g * seg:(g + 1) * seg]
    return set(ids[ids >= 0].tolist())


def test_f32_key_ties_go_to_the_lower_segment():
    """Keys 2^25 + 2 (row 5) and 2^25 + 1 (row 9) are one float32, 2^25:
    the lower row wins, though its int32 key is larger; 2^25 + 3 (row 12)
    rounds up and ranks third. Each later winner's rows lie nearer, so the
    best row returned shows how far the ranking went."""
    seg, spt = 16, 4
    a = rescore_args(2, 4, spt, seg, 8, 4, kc=6, nprobe=6, seed=1)
    a["segpack"][:] = 2 ** 30
    a["segpack"][5, 0] = 2 ** 25 + 2
    a["segpack"][9, 0] = 2 ** 25 + 1
    a["segpack"][12, 0] = 2 ** 25 + 3
    assert float(np.float32(2 ** 25 + 2)) == float(np.float32(2 ** 25 + 1))
    a["rowids"][:] = torch.arange(a["rowids"].shape[0], dtype=torch.int32)
    a["nrm_col"][:] = 1e6
    a["seg_cell"][:] = 0
    for r, nrm in ((5, 3e5), (9, 2e5), (12, 1e5)):
        g = int(a["sel"][r // spt]) * spt + r % spt
        a["nrm_col"][g * seg:(g + 1) * seg] = nrm
    for n_take, best in ((1, 5), (2, 9), (3, 12)):
        _, ids = T.ivf_rescore(*positional(a, seg, 1, n_take - 1, True))
        assert int(ids[0, 0]) in _rows_of(a, seg, spt, best)


@pytest.mark.parametrize("n_live", [0, 1, 2])
def test_fill_slots_never_reenter(n_live):
    """Past n_live the slots are fill slots (page 0, keys INT32_MAX): with
    k + slack above the live segments they are taken, and every row of
    theirs stays masked. Page 0 is also a live page here, so a fill row
    that re-entered would repeat one of its ids."""
    seg, spt, k = 16, 4, 40
    a = rescore_args(3, 4, spt, seg, 8, n_live, kc=6, nprobe=6, seed=2)
    a["sel"][:] = 0
    a["sel"][1:max(n_live, 1)] = torch.arange(2, max(n_live, 1) + 1,
                                              dtype=torch.int32)
    a["rowids"][:] = torch.arange(a["rowids"].shape[0], dtype=torch.int32)
    a["nrm_col"][:] = 1e4
    a["seg_cell"][:] = 0
    assert (a["segpack"][n_live * spt:] == I32_MAX).all()
    d, ids = T.ivf_rescore(*positional(a, seg, k, 6, True))
    live = set().union(*(_rows_of(a, seg, spt, r)
                         for r in range(n_live * spt)))
    for row in ids.tolist():
        got = [i for i in row if i >= 0]
        assert len(got) == min(k, len(live)) and set(got) <= live
        assert len(set(got)) == len(got)
    assert torch.isinf(d[ids < 0]).all() and torch.isfinite(d[ids >= 0]).all()


def test_pool_below_k_pads():
    """One slot of one segment (S*spt 1 < k + slack): the pool is its 16
    rows, and the rest of [B, k] is +inf / -1."""
    seg, k = 16, 20
    a = rescore_args(5, 1, 1, seg, 8, 1, kc=6, nprobe=6, seed=3)
    d, ids = T.ivf_rescore(*positional(a, seg, k, 6, False))
    assert d.shape == ids.shape == (5, k)
    assert (ids[:, seg:] == -1).all() and torch.isinf(d[:, seg:]).all()
    fin = torch.isfinite(d)
    assert torch.equal(fin, ids >= 0)
    assert (torch.diff(torch.where(fin, d, 3e38), dim=1) >= 0).all()


def test_exact_probe_masks_unprobed_cells():
    """exact_probe=True keeps each query to the cells it probed;
    exact_probe=False also ranks rows of the batch's other cells."""
    seg, spt = 16, 4
    a = rescore_args(6, 6, spt, seg, 8, 6, kc=12, nprobe=3, seed=4)
    cell_of = {}
    for g, c in enumerate(a["seg_cell"].tolist()):
        for i in a["rowids"][g * seg:(g + 1) * seg].tolist():
            cell_of[i] = c
    outside = 0
    for exact in (True, False):
        _, ids = T.ivf_rescore(*positional(a, seg, 24, 6, exact))
        for qi, row in enumerate(ids.tolist()):
            cells = {cell_of[i] for i in row if i >= 0}
            off = {c for c in cells if not a["probed_bk"][qi, c]}
            assert -1 not in cells
            if exact:
                assert not off
            outside += len(off)
    assert outside > 0


def test_pad_rows_never_returned():
    """Rows with rowids -1, or a norm at or above BIG / 2, are masked."""
    seg, spt = 32, 2
    a = rescore_args(8, 5, spt, seg, 16, 5, kc=6, nprobe=6, seed=5)
    big = set(a["rowids"][a["nrm_col"][:, 0] >= T.BIG / 2].tolist())
    for exact in (True, False):
        d, ids = T.ivf_rescore(*positional(a, seg, 64, 0, exact))
        got = set(ids[ids >= 0].tolist())
        assert not got & big and -1 in big
        assert torch.isfinite(d[ids >= 0]).all()


def test_cpu_wrapper_runs_twin_records_and_counts_nothing(monkeypatch):
    """On the CPU the wrapper runs the twin: no build, no launch counted;
    `recorded_args` sees its arguments; other devices raise."""
    def refuse():
        raise AssertionError("the CPU path must not load the kernels")
    monkeypatch.setattr(_build, "load", refuse)
    assert wrappers()["ivf_rescore"] is T.ivf_rescore
    a = rescore_args(4, 3, 4, 16, 8, 2, kc=6, seed=6)
    args = positional(a, 16, 10, 6, True)
    before = T.ivf_rescore.launches
    got = recorded_args("ivf_rescore", lambda: T.ivf_rescore(*args))
    assert T.ivf_rescore.launches == before
    assert all(x is y for x, y in zip(got, args))
    want = T.ivf_rescore_plain(*args)
    for g, w in zip(T.ivf_rescore(*args), want):
        assert torch.equal(g, w)
    meta = tuple(x.to("meta") if torch.is_tensor(x) else x for x in args)
    with pytest.raises(ValueError):
        T.ivf_rescore(*meta)
    assert any(s.endswith("ivf_rescore.cu") for s in _build._sources())
    assert T.ivf_rescore.symbol == "cvt_ivf_rescore"
    assert len(T.ivf_rescore.argtypes) == 35


@pytest.mark.parametrize("b,n_segs,n_take,sms", [
    (4096, 35_200, 16, 132), (256, 35_200, 16, 132), (1, 35_200, 16, 132),
    (256, 316_432, 16, 132), (200, 640, 40, 132), (4096, 7, 56, 132),
    (33, 100_000, 16, 114), (256, 35_200, 106, 132)])
def test_rescore_geometry_covers_rows_and_fills_the_card(b, n_segs, n_take,
                                                         sms):
    """Lists of at least k + slack, or of 64 taken in rounds above that."""
    nt, n_chunks, rows = T._rescore_geometry(b, n_segs, n_take, sms)
    assert nt >= min(n_take, T._SEL_LISTS[-1]) and nt in T._SEL_LISTS
    assert rows % T._SEL_WARPS == 0
    assert n_chunks * rows >= n_segs > (n_chunks - 1) * rows
    assert 1 <= n_chunks <= T._SEL_MAX_CHUNKS
    groups = -(-b // 32)
    resident = sms * T._SEL_BLOCKS_PER_SM[nt]
    assert groups * n_chunks <= max(resident, groups)
    if n_segs >= T._SEL_MIN_ROWS * resident:
        assert groups * n_chunks > resident // 2


def test_rescore_smem_budget():
    """The block's shared memory: 6,976 + 4 * n_chunks bytes at the IVF
    cell's D 128, k + slack 16, seg 32; k + slack 64 at seg 128 and D 896
    still fits sm_90's 227 KB; k + slack 606 at seg 32 does not, and its
    candidates spill to device memory, leaving 12,120 + 4 * D + 4 *
    n_chunks bytes."""
    assert T._rescore_smem_bytes(128, 16, 32, 4) == 6_976 + 16
    assert T._rescore_smem_bytes(896, 64, 128, 1024) <= T.SMEM_LIMIT
    assert T._rescore_smem_bytes(128, 606, 32, 4) > T.SMEM_LIMIT
    assert (T._rescore_smem_bytes(128, 606, 32, 4, spill=True)
            == 12_120 + 512 + 16)


def _refused(exc, **change):
    a = rescore_args(40, 20, 4, 16, 8, 3, kc=6, seed=8)
    a.update(change.pop("tensors", {}))
    kw = dict(seg=16, k=10, slack=6)
    kw.update(change)
    args = positional(a, kw["seg"], kw["k"], kw["slack"], True)
    with pytest.raises(exc):
        T._check_rescore(*args[:8], *args[9:13], *args[13:16])


def test_check_refuses_bad_inputs():
    a = rescore_args(40, 20, 4, 16, 8, 3, kc=6, seed=8)
    args = positional(a, 16, 10, 6, True)
    T._check_rescore(*args[:8], *args[9:13], *args[13:16])     # accepted
    _refused(TypeError, tensors={"segpack": a["segpack"].long()})
    _refused(TypeError, tensors={"probed_bk": a["probed_bk"].int()})
    _refused(TypeError, tensors={"dec16_rm": a["dec16_rm"].int()})
    _refused(ValueError, tensors={"q": a["q"].T.contiguous().T})
    _refused(ValueError, tensors={"n_live": a["n_live"].repeat(2)})
    _refused(ValueError, tensors={"segpack": a["segpack"][:-1]})
    _refused(ValueError, tensors={"segpack": a["segpack"][:, :39]
                                  .contiguous()})
    _refused(ValueError, tensors={"seg_cell": a["seg_cell"][:-1]})
    _refused(ValueError, tensors={"coarse_ip": a["coarse_ip"][:, :-1]
                                  .contiguous()})
    _refused(ValueError, seg=8)
    _refused(ValueError, tensors={"rowids": a["rowids"][:-1]})
    T._check_rescore(*args[:8], *args[9:13], 16, 600, 6)     # any k
