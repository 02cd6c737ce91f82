"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (the decision is made in the fixture,
never at import). The kernels are built from csrc/ on first use.

Tolerance: bitwise for the kernels. The twins sum the norm column in the
kernel's order (see `_row_norms`), and every score is an exact integer (the
ADC kernels sum int8 products on the tensor cores, exact in any order).
An index on the card against the same index on the CPU: distances rtol
1e-5 (float32 sums in another order), ids equal except at near-ties.
Where JAX is not installed, skip tests/conftest.py (it imports jax):
    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.index import FlatADCIndex, FlatSQIndex, IVFADCIndex
from cvt_tpu_torch.io import synthetic_sift
from cvt_tpu_torch.ops.kernels import adc_scan as T
from cvt_tpu_torch.ops.kernels import ivf_scan as V
from cvt_tpu_torch.ops.linalg import l2_normalize
from cvt_tpu_torch.quant import ProductQuantizer, ScalarQuantizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, npad=8192, b=200, m=8, k=256, ds=16, seed=0, seg=T.SEG):
    """Random codes and codebooks, queries folded with seg's norm cap."""
    g = torch.Generator().manual_seed(seed)
    cb = torch.randn((m, k, ds), generator=g) * 20
    cb_q, srow = T._quantize_codebooks(cb)
    codes = torch.randint(0, k, (npad, m), generator=g, dtype=torch.uint8)
    q = torch.randn((b, m * ds), generator=g) * 50
    vcap, _ = T._pack_caps(seg, m * ds)
    srow_d = srow.to(dev)
    q2s, qs = T._fold_queries(q.to(dev), srow_d,
                              127.0 ** 2 * torch.sum(srow_d * srow_d), vcap)
    return (q2s, qs, codes.to(dev), cb_q.to(dev), (srow * srow).to(dev),
            cb, q)


@pytest.mark.parametrize("tile_n,n_valid", [(1024, 8192), (2048, 5000)])
def test_segmin_kernel_equals_twin(card, tile_n, n_valid):
    q2s, qs, codes, cb_q, s2, _, _ = _inputs(card)
    before = T.adc_segmin.launches
    sp, tt = T.adc_segmin(q2s, qs, codes, cb_q, s2, n_valid, tile_n)
    torch.cuda.synchronize()
    assert T.adc_segmin.launches == before + 1
    psp, ptt = T.adc_segmin_plain(q2s, qs, codes, cb_q, s2, n_valid, tile_n)
    assert torch.equal(sp, psp)
    assert torch.equal(tt, ptt)


def test_segmin_cached_kernel_equals_twin(card):
    q2s, qs, codes, cb_q, s2, _, _ = _inputs(card)
    dec = T.decode_int8(codes, cb_q)
    dec8_t = dec.T.contiguous()
    norm_col = T._row_norms(dec, s2)[:, None].contiguous()
    before = T.adc_segmin_cached.launches
    sp, tt = T.adc_segmin_cached(q2s, qs, dec8_t, norm_col, 7000, 2048)
    torch.cuda.synchronize()
    assert T.adc_segmin_cached.launches == before + 1
    psp, ptt = T.adc_segmin_cached_plain(q2s, qs, dec8_t, norm_col, 7000,
                                         2048)
    assert torch.equal(sp, psp)
    assert torch.equal(tt, ptt)


def _packable(seg: int, d: int) -> bool:
    try:
        T._pack_caps(seg, d)
    except ValueError:
        return False
    return True


_EDGE_SHAPES = [  # npad, b, m, k, ds, n_valid, tile_n
    (128, 100, 4, 64, 9, 77, 128),        # D = 36: k zero-padded to 64
    (640, 128, 8, 64, 16, 500, 128),      # Npad % 256 != 0; Bpad = 128
    (1152, 300, 2, 64, 20, 1100, 128),    # D = 40; last query tile partial
    (8192, 200, 8, 256, 16, 7892, 1024),  # n_valid inside a tile
    (8192, 200, 8, 256, 16, 7892, 256),
    (1024, 200, 16, 256, 16, 1000, 256),  # D = 256: two K panels
    (512, 200, 48, 64, 16, 450, 256),     # D = 768: two query tiles
]


@pytest.mark.parametrize("npad,b,m,k,ds,n_valid,tile_n,seg", [
    (*shape, seg) for shape in _EDGE_SHAPES for seg in T.SEGS
    if _packable(seg, shape[2] * shape[4])])   # D = 768 needs seg <= 32
def test_both_kernels_equal_twins_at_edge_shapes(card, npad, b, m, k, ds,
                                                 n_valid, tile_n, seg):
    """Both tensor-core kernels against their twins, bitwise, at shapes
    that stress the fragment maps: D not a multiple of 32, several K
    panels, one query tile, one row block, Npad not a multiple of 256,
    n_valid inside a block, and a D whose query ring falls back to two
    tiles, at every segment size whose int32 keys hold that D."""
    q2s, qs, codes, cb_q, s2, _, _ = _inputs(card, npad=npad, b=b, m=m,
                                             k=k, ds=ds, seg=seg)
    args = (q2s, qs, codes, cb_q, s2, n_valid, tile_n, seg)
    got, want = T.adc_segmin(*args), T.adc_segmin_plain(*args)
    torch.cuda.synchronize()
    assert got[0].shape == (npad // seg, q2s.shape[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    dec = T.decode_int8(codes, cb_q)
    cargs = (q2s, qs, dec.T.contiguous(),
             T._row_norms(dec, s2)[:, None].contiguous(), n_valid, tile_n,
             seg)
    got = T.adc_segmin_cached(*cargs)
    want = T.adc_segmin_cached_plain(*cargs)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wrappers_refuse_bad_inputs(card):
    q2s, qs, codes, cb_q, s2, _, _ = _inputs(card)
    with pytest.raises(ValueError):
        T.adc_segmin(q2s, qs, codes.cpu(), cb_q, s2, 8192, 1024)
    with pytest.raises(TypeError):
        T.adc_segmin(q2s, qs, codes.int(), cb_q, s2, 8192, 1024)
    with pytest.raises(ValueError):
        T.adc_segmin(q2s, qs, codes, cb_q, s2, 8192, 1000)
    with pytest.raises(ValueError):
        T.adc_segmin(q2s, qs, codes, cb_q, s2, 8192, 1024, 4)
    with pytest.raises(ValueError):
        T.adc_segmin(q2s, qs, codes[:8192 - 64], cb_q, s2, 8000, 64, 32)
    wide = torch.zeros((128, 1024), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="227 KB"):   # D = 1024 at seg 8
        T.adc_segmin_cached(wide, qs, torch.zeros((1024, 1024),
                                                  dtype=torch.int8,
                                                  device=card),
                            torch.zeros((1024, 1), device=card), 1024, 1024,
                            8)


def test_index_on_card_equals_index_on_cpu(card):
    _, _, _, _, _, cb, q = _inputs("cpu", npad=4096)
    codes = torch.randint(0, 256, (5000, 8), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(1))
    res = {}
    for dev in ("cpu", "cuda"):
        idx = FlatADCIndex(ProductQuantizer(cb, device=dev), impl="kernel")
        idx.add(codes=codes)
        fast = idx.search(q, 10)
        exact = idx.search(q, 10, exact=True)
        idx.build_decoded_cache()
        cached = idx.search(q, 10)
        res[dev] = [t.cpu() for pair in (fast, exact, cached) for t in pair]
    for a, b in zip(res["cpu"], res["cuda"]):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5)


def test_loaded_index_lands_on_the_card(card, tmp_path):
    """FlatADCIndex.load with no device puts the index on the card, where
    its searches launch the kernel."""
    _, _, _, _, _, cb, q = _inputs("cpu", npad=4096)
    idx = FlatADCIndex(ProductQuantizer(cb, device="cpu"), impl="kernel")
    idx.add(codes=torch.randint(0, 256, (3000, 8), dtype=torch.uint8,
                                generator=torch.Generator().manual_seed(2)))
    idx.save(str(tmp_path / "pack.npz"))
    loaded = FlatADCIndex.load(str(tmp_path / "pack.npz"))
    assert loaded.device.type == "cuda" and loaded._codes.is_cuda
    assert loaded._resolve_impl() == "kernel"
    before = T.adc_segmin.launches
    _, i = loaded.search(q.numpy(), 10)
    torch.cuda.synchronize()
    assert T.adc_segmin.launches == before + 1 and i.is_cuda
    assert torch.equal(i.cpu(), idx.search(q, 10)[1])


def _page_args(dev, d=128, b=200, seg=32, seed=0, kc=10):
    """Seeded ivf_page arguments over 6 pages of 512 rows: BIG pad rows
    and a page of them (page 4, slot 1), kc cells in cell order over the
    segments with dead segments and a page of them (page 1, slot 4),
    BIG-masked coarse terms and a cell masked for every query, masked
    padded query columns (Bpad > B) and a repeated fill page in sel."""
    g = torch.Generator().manual_seed(seed)
    nvcap, _ = V._ivf_pack_caps(seg, d)
    lp, n_pages = 512, 6
    spt = lp // seg
    bpad = -(-b // 128) * 128
    qs = torch.rand((1,), generator=g) + 0.5
    dec8_t = torch.randint(-127, 128, (d, n_pages * lp), generator=g,
                           dtype=torch.int8)
    nrm = torch.rand((n_pages * lp, 1), generator=g) * 0.9 * nvcap * qs
    nrm[torch.rand(nrm.shape, generator=g) < 0.1] = V.BIG
    nrm[4 * lp:5 * lp] = V.BIG
    seg_cell = torch.randint(0, kc, (n_pages * spt,), generator=g,
                             dtype=torch.int32).sort().values
    seg_cell[torch.rand(seg_cell.shape, generator=g) < 0.1] = -1
    seg_cell[spt:2 * spt] = -1
    sel = torch.tensor([3, 4, 0, 5, 1, 0, 0], dtype=torch.int32)
    cipc = torch.rand((kc, bpad), generator=g) * 0.9 * 127 ** 2 * d * qs
    cipc[torch.rand(cipc.shape, generator=g) < 0.3] = V.BIG
    cipc[kc // 2] = V.BIG
    cipc[:, b:] = V.BIG
    q2s = torch.randint(-127, 128, (bpad, d), generator=g, dtype=torch.int8)
    q2s[b:] = 0
    return [x.to(dev) for x in (q2s, qs, dec8_t, nrm, cipc, seg_cell, sel)]


def _ivf_packable(seg: int, d: int) -> bool:
    try:
        V._ivf_pack_caps(seg, d)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("seg,d,b", [
    (seg, d, b) for seg in (16, 32, 64, 128) for d in (36, 64, 128, 256)
    for b in (100, 200, 300)                 # Bpad 128 / 256 / 384
    if _ivf_packable(seg, d)])               # D 256 needs seg <= 64
def test_ivf_page_kernel_equals_twin(card, seg, d, b):
    """The tensor-core page scan against its twin, bitwise, at every
    segment size, D not a multiple of 32 (36), one and two K panels, and
    one to six query tiles."""
    args = _page_args(card, d, b, seg)
    before = V.ivf_pages_segmin.launches
    got = V.ivf_pages_segmin(*args, 512, seg)
    torch.cuda.synchronize()
    assert V.ivf_pages_segmin.launches == before + 1
    want = V.ivf_pages_segmin_plain(*args, 512, seg)
    assert torch.equal(got, want)
    # the page of pad rows under masked terms carries both float32 markers
    _, marker = V._ivf_pack_caps(seg, d)
    spt = 512 // seg
    floor = (2 * int(V._marker_f32(marker)) - 127 ** 2 * d) * seg
    assert int(got[spt:2 * spt].max()) >= floor


@pytest.mark.parametrize("n_live", [0, 1, 6, 7])        # S = 7
def test_ivf_page_kernel_skips_fill_slots(card, n_live):
    """Slots past n_live and page ids out of range (slot 1: -1, slot 3:
    past the cache) write INT32_MAX in the kernel as in its twin; the rest
    are the full scan's keys."""
    args = _page_args(card)
    full = V.ivf_pages_segmin_plain(*args, 512, 32)
    args[6] = torch.tensor([3, -1, 0, 6, 1, 0, 0], dtype=torch.int32,
                           device=card)
    live = torch.tensor([n_live], dtype=torch.int32, device=card)
    got = V.ivf_pages_segmin(*args, 512, 32, live)
    torch.cuda.synchronize()
    assert torch.equal(got, V.ivf_pages_segmin_plain(*args, 512, 32, live))
    skip = torch.tensor([s >= n_live or s in (1, 3) for s in range(7)],
                        device=card).repeat_interleave(16)
    assert bool((got[skip] == V.I32_MAX).all())
    assert torch.equal(got[~skip], full[~skip])


def test_ivf_page_two_tile_ring(card):
    """D = 896, the largest D whose block fits 227 KB, and then only with
    two query tiles in the ring (seg 16: the int32 keys hold that D)."""
    assert V._page_smem_bytes(896, 3) > V.SMEM_LIMIT
    assert V._page_smem_bytes(896, 2) <= V.SMEM_LIMIT
    args = _page_args(card, 896, 300, 16)
    got = V.ivf_pages_segmin(*args, 512, 16)
    torch.cuda.synchronize()
    assert torch.equal(got, V.ivf_pages_segmin_plain(*args, 512, 16))


def test_ivf_wrapper_refuses_bad_inputs(card):
    q2s, qs, dec8_t, nrm, cipc, seg_cell, sel = _page_args(card)
    with pytest.raises(ValueError):
        V.ivf_pages_segmin(q2s, qs, dec8_t.cpu(), nrm, cipc, seg_cell, sel,
                           512, 32)
    with pytest.raises(TypeError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm.double(), cipc, seg_cell,
                           sel, 512, 32)
    with pytest.raises(ValueError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc.T.contiguous().T,
                           seg_cell, sel, 512, 32)
    with pytest.raises(ValueError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc[:, :128].contiguous(),
                           seg_cell, sel, 512, 32)
    with pytest.raises(TypeError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc, seg_cell, sel, 512, 32,
                           torch.ones(1, dtype=torch.int64, device=card))
    with pytest.raises(ValueError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cipc, seg_cell, sel, 512, 32,
                           torch.ones(2, dtype=torch.int32, device=card))
    wide = torch.zeros((128, 900), dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="227 KB"):      # D = 900 at seg 16
        V.ivf_pages_segmin(wide, qs, torch.zeros((900, 512), dtype=torch.int8,
                                                 device=card),
                           torch.zeros((512, 1), device=card),
                           torch.zeros((1, 128), device=card),
                           torch.zeros(32, dtype=torch.int32, device=card),
                           torch.zeros(1, dtype=torch.int32, device=card),
                           512, 16)


def _assert_ids_match(d, i, cd, ci, rel=1e-4, atol=0.0):
    """rtol 1e-5 (plus `atol`) on distances; an id may differ only where
    the CPU row holds another distance within `rel` of it, or at the last
    slot."""
    np.testing.assert_allclose(d, cd, rtol=1e-5, atol=atol)
    for r, c in zip(*np.nonzero(i != ci)):
        if c < ci.shape[1] - 1:
            gap = np.abs(np.delete(cd[r], c) - cd[r, c])
            assert gap.min() <= rel * max(abs(cd[r, c]), 1.0), (r, c)


def test_ivf_index_on_card_equals_index_on_cpu(card):
    base, queries = synthetic_sift(8192, 128, n_queries=64, seed=0)
    cpu = IVFADCIndex(coarse_k=64, m=8, k=64, bucket_cap=96, device="cpu")
    cpu.train(torch.Generator().manual_seed(0), base[:4096], coarse_iters=4,
              pq_iters=4)
    a, c, dq = (x.numpy() for x in cpu.encode_chunk(base))
    cpu.build_from_codes(a, c, dq)
    gpu = IVFADCIndex(coarse_k=64, m=8, k=64, bucket_cap=96, device="cuda")
    gpu.centroids = cpu.centroids.to(card)
    gpu.pq = ProductQuantizer(cpu.pq.codebooks, device=card)
    gpu.build_from_codes(a, c, dq)
    before = V.ivf_pages_segmin.launches
    for name, kw in (("search_fast", {}),
                     ("search_fast", {"exact_probe": False}),
                     ("search", {})):
        got = getattr(gpu, name)(queries, 10, nprobe=8, **kw)
        want = getattr(cpu, name)(queries, 10, nprobe=8, **kw)
        _assert_ids_match(got[0].cpu().numpy(), got[1].cpu().numpy(),
                          want[0].numpy(), want[1].numpy())
    assert V.ivf_pages_segmin.launches == before + 2


def test_flat_sq_on_card_equals_cpu(card):
    """FlatSQIndex on the card against the same index on the CPU. Codes
    are elementwise float32 operations, so they agree bitwise. With the
    CPU's decoded cache carried to the card, search_fast's ids agree
    bitwise (the keys are exact integers); with the card's own cache the
    norm column agrees to rtol 1e-6 (a float32 sum in another order) and
    top-1 ids on >= 99% of queries. A distance is a query norm (~1, a
    float32 sum in another order on each device) plus a score of nearly
    its size, so its error is absolute: rtol 1e-5 plus atol 2e-6, a few
    ulp of the norm. search (bf16, int8): the same on distances, ids
    equal except at near-ties."""
    base, queries = synthetic_sift(6000, 64, n_queries=128, seed=0)
    xb = l2_normalize(torch.from_numpy(base))
    xq = l2_normalize(torch.from_numpy(queries))
    sq = ScalarQuantizer.train(xb)
    cpu = FlatSQIndex(sq)
    cpu.add(xb)
    gpu = FlatSQIndex(sq, device=card)
    gpu.add(xb.to(card))
    assert torch.equal(gpu._codes_s8.cpu(), cpu._codes_s8)
    want = cpu.search_fast(xq, 10)
    before = T.adc_segmin_cached.launches
    own = gpu.search_fast(xq, 10)
    assert T.adc_segmin_cached.launches == before + 1
    np.testing.assert_allclose(gpu._norm_col.cpu().numpy(),
                               cpu._norm_col.numpy(), rtol=1e-6)
    top1 = (own[1][:, 0].cpu() == want[1][:, 0]).float().mean()
    assert float(top1) >= 0.99
    gpu._dec8_t = cpu._dec8_t.to(card)
    gpu._norm_col = cpu._norm_col.to(card)
    got = gpu.search_fast(xq, 10)
    assert torch.equal(got[1].cpu(), want[1])
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-5, atol=2e-6)
    for mode in ("bf16", "int8"):
        cpu.mode = gpu.mode = mode
        d, i = gpu.search(xq, 10)
        cd, ci = cpu.search(xq, 10)
        _assert_ids_match(d.cpu().numpy(), i.cpu().numpy(), cd.numpy(),
                          ci.numpy(), atol=2e-6)


def test_server_one_rank_nccl_equals_cpu(card):
    """A 1-rank NCCL group on the card: MultiHostADCServer (allgather,
    ring, pipelined) and ShardedADCSearcher(impl='kernel') against the
    same shard scanned on the CPU by the twin. 1,000 rows at tile 128
    leave 8 segments of 128 < k, so the segment falls to 64. ids
    bitwise (the twin's norms are the kernel's), distances rtol 1e-5."""
    import torch.distributed as dist
    from cvt_tpu_torch.parallel import (MultiHostADCServer,
                                        ShardedADCSearcher,
                                        init_distributed, serving_mesh)
    from cvt_tpu_torch.parallel.sharded_search import (_local_pallas_topk,
                                                       _segment_plan)
    _, _, _, _, _, cb, q = _inputs("cpu")
    codes = torch.randint(0, 256, (1000, 8), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    assert init_distributed() == 0
    try:
        assert dist.get_backend() == "nccl"
        mesh = serving_mesh()
        pq = ProductQuantizer(cb)
        got = {}
        for merge in ("allgather", "ring"):
            srv = MultiHostADCServer(pq, mesh, merge=merge, tile_n=128)
            srv.load(codes=codes)
            got[merge] = srv.serve(q, 10)
        pipe = srv.serve_pipelined(q[:192].reshape(2, 96, -1), 10)
        searcher = ShardedADCSearcher(pq, mesh, impl="kernel", chunk=128,
                                      tile_n=128)
        searcher.load(codes=codes)
        got["searcher"] = searcher.search(q, 10)
        per = srv._per
        tile_n, seg = _segment_plan(per, 128, 128, 10)
        assert (per, tile_n, seg) == (1024, 128, 64)
        cb_q, srow = T._quantize_codebooks(cb)
        padded = torch.nn.functional.pad(codes, (0, 0, 0, per - 1000))
        wd, wi = _local_pallas_topk(q, padded, cb_q, srow, 10, 1000, tile_n,
                                    seg)
        for d, i in got.values():
            assert torch.equal(i.cpu(), wi)
            np.testing.assert_allclose(d.cpu().numpy(), wd.numpy(),
                                       rtol=1e-5)
        # each micro-batch folds its own queries, as serve() on it does
        parts = [srv.serve(q[96 * t:96 * (t + 1)], 10) for t in range(2)]
        assert torch.equal(pipe[1], torch.cat([p[1] for p in parts]))
        assert torch.equal(pipe[0], torch.cat([p[0] for p in parts]))
    finally:
        dist.destroy_process_group()
