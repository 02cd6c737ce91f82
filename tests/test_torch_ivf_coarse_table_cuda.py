"""`ivf_page_kernel` on the per-cell coarse-term table, on the card.

The kernel reads each segment's coarse term from cipc [Kc, Bpad] through
seg_cell; its twin expands the same lookup in PyTorch. Bitwise at seg 16,
32 and 64 on a page of pad rows, dead segments, BIG-masked cells and
padded query columns, with every slot live and with a live count below S;
`_check_launch` refuses a cell id past Kc and a table of the wrong shape.
Then one `search_fast` batch at the IVF cell's shape (1M x 128, coarseK
8,192, m 16, B 4,096, nprobe 16) on the card against the same index on the
CPU, which runs the twins: distances rtol 1e-5, ids equal except at
near-ties (the union-search tolerance: the coarse products and the
rescore sum in another order).

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false. Where JAX is not installed, skip
tests/conftest.py (it imports jax):
    python -m pytest tests/test_torch_ivf_coarse_table_cuda.py --noconftest
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.index import IVFADCIndex
from cvt_tpu_torch.io import synthetic_sift
from cvt_tpu_torch.ops.kernels import ivf_scan as V
from cvt_tpu_torch.ops.kernels import recorded_args
from cvt_tpu_torch.quant import ProductQuantizer

pytestmark = pytest.mark.cuda

LP, KC = 512, 40


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _table_args(dev, seg, d=128, b=300, seed=0):
    """Seeded ivf_page arguments over 8 pages of 512 rows: BIG pad rows and
    a page of them (page 2, slot 0), KC cells in cell order over the
    segments, dead segments and a page of them (page 5, slot 3), BIG-masked
    table entries and two cells masked for every query, padded query
    columns (B 300, Bpad 384) and fill slots repeating page 0."""
    g = torch.Generator().manual_seed(seed)
    nvcap, _ = V._ivf_pack_caps(seg, d)
    n_pages, spt = 8, LP // seg
    bpad = -(-b // 128) * 128
    qs = torch.rand((1,), generator=g) + 0.5
    dec8_t = torch.randint(-127, 128, (d, n_pages * LP), generator=g,
                           dtype=torch.int8)
    nrm = torch.rand((n_pages * LP, 1), generator=g) * 0.9 * nvcap * qs
    nrm[torch.rand(nrm.shape, generator=g) < 0.1] = V.BIG
    nrm[2 * LP:3 * LP] = V.BIG
    seg_cell = torch.randint(0, KC, (n_pages * spt,), generator=g,
                             dtype=torch.int32).sort().values
    seg_cell[torch.rand(seg_cell.shape, generator=g) < 0.1] = -1
    seg_cell[5 * spt:6 * spt] = -1
    sel = torch.tensor([2, 7, 0, 5, 3, 6, 1, 4, 0, 0], dtype=torch.int32)
    cipc = torch.rand((KC, bpad), generator=g) * 0.9 * 127 ** 2 * d * qs
    cipc[torch.rand(cipc.shape, generator=g) < 0.3] = V.BIG
    cipc[[3, KC - 1]] = V.BIG
    cipc[:, b:] = V.BIG
    q2s = torch.randint(-127, 128, (bpad, d), generator=g, dtype=torch.int8)
    q2s[b:] = 0
    return [x.to(dev) for x in (q2s, qs, dec8_t, nrm, cipc, seg_cell, sel)]


@pytest.mark.parametrize("n_live", [None, 6])               # S = 10
@pytest.mark.parametrize("seg", [16, 32, 64])
def test_page_kernel_reads_the_table_bitwise(card, seg, n_live):
    args = _table_args(card, seg) + [LP, seg]
    if n_live is not None:
        args.append(torch.tensor([n_live], dtype=torch.int32, device=card))
    before = V.ivf_pages_segmin.launches
    got = V.ivf_pages_segmin(*args)
    torch.cuda.synchronize()
    assert V.ivf_pages_segmin.launches == before + 1
    want = V.ivf_pages_segmin_plain(*args)
    assert torch.equal(got, want)
    spt = LP // seg
    live = (n_live or 10) * spt
    assert bool((got[live:] == V.I32_MAX).all())
    # slot 3's page is all dead segments: every key there carries the
    # clipped marker as its coarse term
    _, marker = V._ivf_pack_caps(seg, 128)
    floor = (int(V._marker_f32(marker)) - 127 ** 2 * 128) * seg
    assert int(got[3 * spt:4 * spt].min()) >= floor


def test_page_kernel_refuses_a_cell_past_kc(card):
    q2s, qs, dec8_t, nrm, cipc, seg_cell, sel = _table_args(card, 32)
    before = V.ivf_pages_segmin.launches
    past = seg_cell.clone()
    past[40] = KC
    with pytest.raises(ValueError, match="past cipc"):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc, past, sel, LP, 32)
    # changed in place after a call, the table is read again
    ok = seg_cell.clone()
    V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc, ok, sel, LP, 32)
    ok[-1] = KC + 7
    with pytest.raises(ValueError, match="past cipc"):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc, ok, sel, LP, 32)
    with pytest.raises(ValueError, match="seg_cell must be"):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc, seg_cell[:-1], sel,
                           LP, 32)
    with pytest.raises(TypeError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc, seg_cell.long(), sel,
                           LP, 32)
    with pytest.raises(ValueError, match="cipc must be"):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc[:0], seg_cell, sel,
                           LP, 32)
    torch.cuda.synchronize()
    assert V.ivf_pages_segmin.launches == before + 1


def _assert_ids_match(d, i, cd, ci, rel=1e-4):
    """Distances rtol 1e-5; an id may differ only where the CPU row holds
    another distance within `rel` of it, or at the last slot."""
    np.testing.assert_allclose(d, cd, rtol=1e-5)
    for r, c in zip(*np.nonzero(i != ci)):
        if c < ci.shape[1] - 1:
            gap = np.abs(np.delete(cd[r], c) - cd[r, c])
            assert gap.min() <= rel * max(abs(cd[r, c]), 1.0), (r, c)


def test_search_fast_at_the_cell_shape_against_the_cpu(card):
    base, queries = synthetic_sift(1_000_000, 128, n_queries=4096, seed=0)
    gpu = IVFADCIndex(coarse_k=8192, m=16, k=256, device=card)
    gpu.train(torch.Generator().manual_seed(0), base, coarse_iters=2,
              pq_iters=2, sample=131_072)
    base_d = torch.from_numpy(base).to(card)
    parts = [gpu.encode_chunk(base_d[s:s + gpu.ENC_CHUNK])
             for s in range(0, len(base), gpu.ENC_CHUNK)]
    a, c, dq = (torch.cat([p[j] for p in parts]).cpu().numpy()
                for j in range(3))
    gpu.build_from_codes(a, c, dq)
    cpu = IVFADCIndex(coarse_k=8192, m=16, k=256, device="cpu")
    cpu.centroids = gpu.centroids.cpu()
    cpu.pq = ProductQuantizer(gpu.pq.codebooks.cpu(), device="cpu")
    cpu.build_from_codes(a, c, dq)
    budget = 4096 * 16 * gpu.cell_pages()
    args = recorded_args("ivf_page", lambda: gpu.search_fast(
        queries, 10, nprobe=16, max_pages=budget))
    assert args[4].shape == (8192, 4096) and args[6].shape[0] > 1500
    assert torch.equal(V.ivf_pages_segmin(*args),
                       V.ivf_pages_segmin_plain(*args))
    got_d, got_i, drop = gpu.search_fast(queries, 10, nprobe=16,
                                         max_pages=budget)
    want_d, want_i, cdrop = cpu.search_fast(queries, 10, nprobe=16,
                                            max_pages=budget)
    assert int(drop) == int(cdrop) == 0
    _assert_ids_match(got_d.cpu().numpy(), got_i.cpu().numpy(),
                      want_d.numpy(), want_i.numpy())
