"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (the decision is made in the fixture,
never at import). The kernels are built from csrc/ on first use.

Tolerance: bitwise for the kernels. The twins sum the norm column in the
kernel's order (see `_row_norms`), and every score is an exact integer.
An index on the card against the same index on the CPU: distances rtol
1e-5 (float32 sums in another order), ids equal except at near-ties.
Where JAX is not installed, skip tests/conftest.py (it imports jax):
    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.index import FlatADCIndex, IVFADCIndex
from cvt_tpu_torch.io import synthetic_sift
from cvt_tpu_torch.ops.kernels import adc_scan as T
from cvt_tpu_torch.ops.kernels import ivf_scan as V
from cvt_tpu_torch.quant import ProductQuantizer

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, npad=8192, b=200, m=8, k=256, ds=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    cb = torch.randn((m, k, ds), generator=g) * 20
    cb_q, srow = T._quantize_codebooks(cb)
    codes = torch.randint(0, k, (npad, m), generator=g, dtype=torch.uint8)
    q = torch.randn((b, m * ds), generator=g) * 50
    q2s, qs = T._fold_for(q.to(dev), srow.to(dev), m * ds)
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


def test_wrappers_refuse_bad_inputs(card):
    q2s, qs, codes, cb_q, s2, _, _ = _inputs(card)
    with pytest.raises(ValueError):
        T.adc_segmin(q2s, qs, codes.cpu(), cb_q, s2, 8192, 1024)
    with pytest.raises(TypeError):
        T.adc_segmin(q2s, qs, codes.int(), cb_q, s2, 8192, 1024)
    with pytest.raises(ValueError):
        T.adc_segmin(q2s, qs, codes, cb_q, s2, 8192, 1000)


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


def _page_args(dev, d=128, b=200, seed=0):
    """Seeded ivf_page arguments over 6 pages of 512 rows (seg 32): BIG
    pad rows and a page of them, BIG-masked cip entries, masked padded
    query columns (Bpad > B) and a repeated fill page in sel."""
    g = torch.Generator().manual_seed(seed)
    nvcap, _ = V._ivf_pack_caps(32, d)
    lp, spt, n_pages = 512, 16, 6
    bpad = -(-b // 128) * 128
    qs = torch.rand((1,), generator=g) + 0.5
    dec8_t = torch.randint(-127, 128, (d, n_pages * lp), generator=g,
                           dtype=torch.int8)
    nrm = torch.rand((n_pages * lp, 1), generator=g) * 0.9 * nvcap * qs
    nrm[torch.rand(nrm.shape, generator=g) < 0.1] = V.BIG
    nrm[4 * lp:5 * lp] = V.BIG
    sel = torch.tensor([3, 4, 0, 5, 1, 0, 0], dtype=torch.int32)
    cip = torch.rand((7 * spt, bpad), generator=g) * 0.9 * 127 ** 2 * d * qs
    cip[torch.rand(cip.shape, generator=g) < 0.3] = V.BIG
    cip[-2 * spt:] = V.BIG
    cip[:, b:] = V.BIG
    q2s = torch.randint(-127, 128, (bpad, d), generator=g, dtype=torch.int8)
    q2s[b:] = 0
    return [x.to(dev) for x in (q2s, qs, dec8_t, nrm, cip, sel)]


@pytest.mark.parametrize("d,b", [(64, 128), (128, 200)])
def test_ivf_page_kernel_equals_twin(card, d, b):
    args = _page_args(card, d, b)
    before = V.ivf_pages_segmin.launches
    got = V.ivf_pages_segmin(*args, 512, 32)
    torch.cuda.synchronize()
    assert V.ivf_pages_segmin.launches == before + 1
    want = V.ivf_pages_segmin_plain(*args, 512, 32)
    assert torch.equal(got, want)
    # the page of pad rows under masked cip carries both float32 markers
    assert int(got[16:32].max()) >= 2 * 32 * 32_522_144 - 127 ** 2 * d * 32


def test_ivf_wrapper_refuses_bad_inputs(card):
    q2s, qs, dec8_t, nrm, cip, sel = _page_args(card)
    with pytest.raises(ValueError):
        V.ivf_pages_segmin(q2s, qs, dec8_t.cpu(), nrm, cip, sel, 512, 32)
    with pytest.raises(TypeError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm.double(), cip, sel, 512, 32)
    with pytest.raises(ValueError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cip.T.contiguous().T, sel,
                           512, 32)
    with pytest.raises(ValueError):
        V.ivf_pages_segmin(q2s, qs, dec8_t, nrm, cip[:-16], sel, 512, 32)


def _assert_ids_match(d, i, cd, ci, rel=1e-4):
    """rtol 1e-5 on distances; an id may differ only where the CPU row
    holds another distance within `rel` of it, or at the last slot."""
    np.testing.assert_allclose(d, cd, rtol=1e-5)
    for r, c in zip(*np.nonzero(i != ci)):
        if c < ci.shape[1] - 1:
            gap = np.abs(np.delete(cd[r], c) - cd[r, c])
            assert gap.min() <= rel * max(abs(cd[r, c]), 1.0), (r, c)


def test_ivf_index_on_card_equals_index_on_cpu(card):
    base, queries = synthetic_sift(8192, 128, n_queries=64, seed=0)
    cpu = IVFADCIndex(coarse_k=64, m=8, k=64, bucket_cap=96)
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
