"""`vocab_coarse_kernel` (csrc/vocab_coarse.cu) on the card against its
plain twin `vocab_coarse_plain` (ops/kernels/vocab_coarse.py: the float32
GEMM expression and the stable sort's first P), and the coarse level of
`hierarchical_assign` through it.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_vocab_coarse_cuda.py --noconftest -m cuda

Tolerance. The kernel sums each dot product as one chain of FMAs over D,
the twin's GEMM in another order. On integer-valued points and centres
every product and partial sum is an integer below 2^24, exact in any
order: distances and cells bitwise, ties included. Elsewhere each
distance lies within its row's `sum_bound` of the twin's, b = 2 (D u / (1
- D u) + 2 u) (|x| + max |c|)^2 with u = 2^-24 (each side's worst-case
float32 summation error, D and the magnitudes alone), and the cells are
equal at every position whose twin distance lies farther than 2 b from
its neighbours' (`compare_coarse_kernel` raises otherwise). The rows
whose P-th and (P+1)-th twin distances lie within 2 b, where the kernel
may keep another P-th cell, must be few (under 10% on these draws of
uint8-valued points; ~6.2% at the cell's shape on the card), and the rows
that do differ fewer still.
"""

import importlib

import pytest
import torch

from cvt_tpu_torch.ops.kernels import vocab_coarse as V

# the module, not `cvt_tpu_torch.ops.kmeans` the function
K = importlib.import_module("cvt_tpu_torch.ops.kmeans")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _draw(gen, dev, m, d, pool=4096):
    """m uint8-valued float32 rows of width d around `pool` random
    centres, as SIFT rows cluster."""
    centres = torch.randint(0, 256, (pool, d), generator=gen,
                            device=dev).float()
    c = centres[torch.randint(0, pool, (m,), generator=gen, device=dev)]
    return (c + 20 * torch.randn((m, d), generator=gen, device=dev)).clamp(
        0, 255).round()


def _inputs(dev, t, d, k1, seed):
    """Points and float coarse centres (not integers: their products
    round) drawn alike, as the cell's are."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    both = _draw(gen, dev, t + k1, d)
    return both[:t].contiguous(), both[t:] + 0.37


def _check(x, centres, p, near_share=0.1):
    """Kernel against the twin (on the card) by the kernel's comparison;
    the counters move by one call's; near ties and differing rows few."""
    t = x.shape[0]
    launches, rows = V.vocab_coarse.launches, V.vocab_coarse.rows
    cmp = V.compare_coarse_kernel((x, centres, p))
    torch.cuda.synchronize()
    assert V.vocab_coarse.launches == launches + (t > 0)
    assert V.vocab_coarse.rows == rows + t
    assert cmp["near_rows"] <= near_share * t, cmp
    assert cmp["rows_differ"] <= max(2, t // 1000), cmp
    return cmp


def test_cell_shape(card):
    """One batch at the vocabulary cell's shape: ~206k rows of 128
    against 1,024 coarse centres, the first 8."""
    x, centres = _inputs(card, 206_000, 128, 1024, 1)
    _check(x, centres, 8)


@pytest.mark.parametrize("t,d,k1,p", [
    (1, 16, 16, 1), (333, 16, 100, 8), (1000, 64, 1024, 16),
    (129, 128, 16, 16), (4097, 100, 100, 8), (257, 36, 1024, 1),
    (3000, 128, 4096, 8), (5000, 20, 1000, 16), (700, 18, 100, 8),
    (300, 127, 1024, 8), (2000, 128, 5000, 8)])
def test_widths_centres_and_probes(card, t, d, k1, p):
    """D 16-128 (a multiple of 16 or not, of 4 or not: the wrapper pads
    x), K1 a multiple of the 128-centre block or not, from P up and past
    4,096, P 1 / 8 / 16, T 1 or ragged across the 128-row blocks."""
    x, centres = _inputs(card, t, d, k1, t + d + k1 + p)
    _check(x, centres, p, near_share=0.15)


@pytest.mark.parametrize("hi,d,k1,p", [(256, 128, 1024, 8), (4, 16, 1024, 16),
                                       (2, 20, 300, 8), (256, 64, 16, 16)])
def test_integer_values_bitwise(card, hi, d, k1, p):
    """Integer points and centres in [0, hi): every order gives the same
    bits, so distances and cells are the twin's bitwise, the many exact
    ties of small ranges going to the lower cell."""
    gen = torch.Generator(device=card).manual_seed(hi + d + k1)
    x = torch.randint(0, hi, (2000, d), generator=gen, device=card).float()
    centres = torch.randint(0, hi, (k1, d), generator=gen,
                            device=card).float()
    got_d, got_i = V.vocab_coarse(x, centres, p)
    want_d, want_i = V.vocab_coarse_plain(x, centres, p)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)


def test_repeated_centres_lower_cell_first(card):
    """Centres repeated within and across the 128-centre blocks, and
    points lying on them: equal distances, the lower cell first."""
    gen = torch.Generator(device=card).manual_seed(7)
    centres = torch.randint(0, 256, (1024, 128), generator=gen,
                            device=card).float()
    centres[900] = centres[3]
    centres[129] = centres[3]
    centres[4] = centres[3]
    centres[1000:1016] = centres[500]
    x = torch.randint(0, 256, (300, 128), generator=gen, device=card).float()
    x[:100] = centres[3]
    x[100:200] = centres[500]
    got_d, got_i = V.vocab_coarse(x, centres, 16)
    want_d, want_i = V.vocab_coarse_plain(x, centres, 16)
    assert torch.equal(got_d, want_d) and torch.equal(got_i, want_i)
    assert got_i[:100, :4].tolist() == [[3, 4, 129, 900]] * 100
    assert got_i[100:200, :1].tolist() == [[500]] * 100
    assert got_i[100:200, 1:16].tolist() == [list(range(1000, 1015))] * 100
    assert bool((got_d[:100, :4] == 0).all())


def test_empty_input_launches_nothing(card):
    centres = torch.rand((100, 16), device=card)
    launches, rows = V.vocab_coarse.launches, V.vocab_coarse.rows
    d, c = V.vocab_coarse(torch.zeros((0, 16), device=card), centres, 4)
    assert d.shape == (0, 4) and c.shape == (0, 4) and c.dtype == torch.int64
    assert (V.vocab_coarse.launches, V.vocab_coarse.rows) == (launches, rows)


def test_refuses_what_it_does_not_take(card):
    """P past 16 or K1, D past 128, and x not contiguous raise on the
    card: there is no second coarse path there."""
    centres = torch.rand((100, 16), device=card)
    for x, c, p in ((torch.rand((4, 16), device=card), centres, 17),
                    (torch.rand((4, 16), device=card), centres[:3], 4),
                    (torch.rand((4, 132), device=card),
                     torch.rand((100, 132), device=card), 4)):
        launches = V.vocab_coarse.launches
        with pytest.raises(ValueError, match="the card takes"):
            V.vocab_coarse(x, c, p)
        assert V.vocab_coarse.launches == launches
    with pytest.raises(ValueError, match="contiguous"):
        V.vocab_coarse(torch.rand((16, 4), device=card).T, centres, 4)


def test_unaligned_points_are_copied(card):
    """x 4 bytes past a 16-byte boundary goes to the kernel as an aligned
    copy: the twin's cells, within the bound."""
    x, centres = _inputs(card, 2001, 64, 300, 5)
    buf = x.new_zeros(2001 * 64 + 1)
    buf[1:] = x.reshape(-1)
    x = buf[1:].view(2001, 64)
    assert x.data_ptr() % 16 == 4
    _check(x, centres, 8, near_share=0.15)


def test_hierarchical_assign_launches_once_a_chunk(card):
    """`hierarchical_assign` on the card takes the kernel for the coarse
    level: one launch a chunk, `.rows` moved by every point, with or
    without uint8 rows on an integer tree (equal words either way)."""
    gen = torch.Generator(device=card).manual_seed(8)
    k1, k2, d, t = 64, 128, 128, 5000
    coarse = _draw(gen, card, k1, d) + 0.37
    fine = _draw(gen, card, k1 * k2, d).reshape(k1, k2, d)
    rows = _draw(gen, card, t, d).to(torch.uint8)
    tree = K.integer_tree(fine)
    assert tree is not None
    got = []
    for kw in ({}, {"tree": tree, "rows": rows}):
        launches, n = V.vocab_coarse.launches, V.vocab_coarse.rows
        got.append(K.hierarchical_assign(rows.float(), coarse, fine,
                                         probes=8, chunk=2000, **kw))
        assert V.vocab_coarse.launches == launches + 3
        assert V.vocab_coarse.rows == n + t
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])
    # outside the kernel's shapes (P 17) the card raises: no plain path
    launches = V.vocab_coarse.launches
    with pytest.raises(ValueError, match="the card takes"):
        K.hierarchical_assign(rows.float(), coarse, fine, probes=17)
    assert V.vocab_coarse.launches == launches
