"""`ivf_rescore_kernel` (csrc/ivf_rescore.cu) against its twin
`ivf_rescore_plain`, on the card.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). The kernels are built from csrc/ on first use.

Tolerance (`ops.kernels.ivf_scan.compare_rescore_kernel`): the segment
ranking is exact, so the same rows are scored; the kernel sums each row's
inner product in another order than the twin, so a distance may differ by
`rescore_tolerance`, a bound relative to the sum of the |products|
(4 D 2^-24 ||q * srow16|| max ||row||, and 8 ulp of the distance's terms).
Ids must equal the twin's except at near-ties: where they differ, the
twin's distance of the kernel's id lies within twice that bound of the
slot's. No id appears twice in a row; the same slots are finite, and -1
past the pool.
Where JAX is not installed, skip tests/conftest.py (it imports jax):
    python -m pytest tests/test_torch_ivf_rescore_cuda.py --noconftest -m cuda
"""

import pytest
import torch

from cvt_tpu_torch.index import IVFADCIndex
from cvt_tpu_torch.io import synthetic_sift
from cvt_tpu_torch.ops.kernels import ivf_scan as V
from cvt_tpu_torch.ops.kernels import recorded_args
from cvt_tpu_torch.ops.kernels.ivf_scan import compare_rescore_kernel
from cvt_tpu_torch.quant import ProductQuantizer
from _ivf_rescore_inputs import KEYS, positional, rescore_args

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _held(args) -> dict:
    before = V.ivf_rescore.launches
    r = compare_rescore_kernel(args)
    torch.cuda.synchronize()
    assert V.ivf_rescore.launches == before + 1
    return r


@pytest.mark.parametrize("exact_probe", [True, False])
def test_kernel_equals_twin_at_the_ivf_cell_shape(card, exact_probe):
    """B 4,096 over 2,200 page slots of 16 segments (35,200 segment rows,
    2,050 slots live), seg 32, D 128, 8,192 cells, nprobe 16, k 10."""
    a = rescore_args(4096, 2200, 16, 32, 128, 2050, kc=8192, nprobe=16,
                     seed=11, device=card)
    r = _held(positional(a, 32, 10, 6, exact_probe))
    assert r["shape"] == [4096, 10]


@pytest.mark.parametrize("b,n_slots,spt,seg,d,n_live,k,exact_probe", [
    (1, 40, 16, 32, 128, 37, 10, True),          # B 1
    (200, 40, 16, 32, 128, 40, 10, False),       # B not a multiple of 128
    (300, 7, 32, 16, 36, 0, 10, True),           # n_live 0: nothing live
    (300, 7, 32, 16, 36, 1, 10, True),           # n_live 1
    (129, 1, 4, 128, 64, 1, 10, False),          # S*spt 4 < k + slack
    (65, 1, 1, 16, 64, 1, 20, True),             # pool of 16 rows < k
    (257, 30, 8, 64, 256, 29, 10, True),         # seg 64, D 256
    (96, 12, 2, 128, 128, 12, 10, False),        # seg 128
    (160, 9, 32, 16, 896, 9, 10, True),          # the largest D, seg 16
    (100, 50, 16, 32, 128, 50, 20, True),        # k + slack 26: lists of 32
    (100, 50, 16, 32, 128, 50, 50, False),       # k + slack 56: lists of 64
    (40, 3000, 16, 32, 128, 2900, 10, True),     # many chunks a query
    (100, 50, 16, 32, 128, 50, 100, True),       # k + slack 106: 2 rounds
    (300, 200, 16, 32, 128, 190, 100, False),    # 2 rounds, many chunks
    (50, 20, 4, 64, 128, 3, 100, True),          # rows run out in round 1
    (64, 60, 16, 32, 128, 58, 600, False),       # 10 rounds; spilled pool
])
def test_kernel_equals_twin_at_edge_shapes(card, b, n_slots, spt, seg, d,
                                           n_live, k, exact_probe):
    a = rescore_args(b, n_slots, spt, seg, d, n_live, seed=b + d,
                     device=card)
    r = _held(positional(a, seg, k, 6, exact_probe))
    assert r["shape"] == [b, k]


def test_kernel_ranks_f32_key_ties_by_segment(card):
    """Every key of a query tied in float32 (one band of 4 integers): the
    winners are the lowest rows, as the twin takes them."""
    a = rescore_args(64, 40, 16, 32, 128, 40, seed=3, device=card)
    a["segpack"][:] = 2 ** 25 + torch.randint(
        0, 2, a["segpack"].shape, device=card, dtype=torch.int32)
    args = positional(a, 32, 10, 6, True)
    _held(args)
    got = V.ivf_rescore(*args)[1]
    assert torch.equal(got, V.ivf_rescore_plain(*args)[1])


def test_wrapper_refuses_bad_inputs(card):
    a = rescore_args(40, 20, 4, 16, 8, 20, kc=6, seed=8, device=card)
    good = positional(a, 16, 10, 6, True)

    def call(**change):
        args = list(good)
        for name, t in change.items():
            args[KEYS.index(name)] = t
        V.ivf_rescore(*args)

    before = V.ivf_rescore.launches
    with pytest.raises(ValueError):
        call(dec16_rm=a["dec16_rm"].cpu())
    with pytest.raises(TypeError):
        call(nrm_col=a["nrm_col"].double())
    with pytest.raises(TypeError):
        call(n_live=a["n_live"].long())
    with pytest.raises(ValueError):
        call(coarse_ip=a["coarse_ip"].T.contiguous().T)
    with pytest.raises(ValueError):
        call(segpack=a["segpack"][:-3])
    with pytest.raises(ValueError):
        call(q_sq=a["q_sq"][:-1])
    with pytest.raises(ValueError):
        call(rowids=a["rowids"][:-1])
    with pytest.raises(ValueError):
        V.ivf_rescore(*good[:13], 8, 10, 6, True)       # seg 8
    assert V.ivf_rescore.launches == before


def test_search_fast_launches_the_kernel_once(card):
    """search_fast on the card runs phase 2 as one counted ivf_rescore
    call, held against the twin on that call's own arguments."""
    base, queries = synthetic_sift(8192, 128, n_queries=300, seed=0)
    cpu = IVFADCIndex(coarse_k=64, m=8, k=64, bucket_cap=96, device="cpu")
    cpu.train(torch.Generator().manual_seed(0), base[:4096], coarse_iters=4,
              pq_iters=4)
    a, c, dq = (x.numpy() for x in cpu.encode_chunk(base))
    gpu = IVFADCIndex(coarse_k=64, m=8, k=64, bucket_cap=96, device="cuda")
    gpu.centroids = cpu.centroids.to(card)
    gpu.pq = ProductQuantizer(cpu.pq.codebooks, device=card)
    gpu.build_from_codes(a, c, dq)
    before = V.ivf_rescore.launches
    for exact in (True, False):
        gpu.search_fast(queries, 10, nprobe=8, exact_probe=exact)
    torch.cuda.synchronize()
    assert V.ivf_rescore.launches == before + 2
    for k in (10, 100):
        args = recorded_args("ivf_rescore", lambda: gpu.search_fast(
            queries, k, nprobe=8))
        assert args[1].is_cuda and args[0].shape[1] == 384
        _held(args)
