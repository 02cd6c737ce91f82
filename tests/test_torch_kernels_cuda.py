"""The CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (the decision is made in the fixture,
never at import). The kernels are built from csrc/ on first use.

Tolerance: bitwise. The twin sums the norm column in the kernel's order
(see `_row_norms`), and every score is an exact integer.
Where JAX is not installed, skip tests/conftest.py (it imports jax):
    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from cvt_tpu_torch.index import FlatADCIndex
from cvt_tpu_torch.ops.kernels import adc_scan as T
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
