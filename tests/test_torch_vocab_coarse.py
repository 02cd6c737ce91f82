"""The coarse level of the vocabulary tree's descent on the CPU: the plain
twin `vocab_coarse_plain` (ops/kernels/vocab_coarse.py), which the
`vocab_coarse` wrapper runs for CPU tensors, against the selection
`_hier_assign_chunk` took before the kernel (the [T, K1] float32
distances and `top_k_smallest`), bitwise; the shapes the card takes
(`shape_ok`) and `hierarchical_assign`'s coarse level through the
wrapper at any shape on the CPU; the
summation bound of `compare_coarse_kernel` against float64, and the
comparison itself. `hierarchical_assign` against `cvt_tpu` is held in
tests/test_torch_kmeans_hier.py, through this twin.

Tolerances: bitwise, but `sum_bound`, which is the tolerance under test."""

import importlib

import pytest
import torch

from cvt_tpu_torch.ops.kernels import _build
from cvt_tpu_torch.ops.kernels import vocab_coarse as V
from cvt_tpu_torch.ops.topk import top_k_smallest

K = importlib.import_module("cvt_tpu_torch.ops.kmeans")


def _former(x, coarse, probes):
    """The coarse selection as `_hier_assign_chunk` wrote it inline."""
    x_sq = torch.sum(x * x, -1, keepdim=True)
    d1 = (x_sq - 2.0 * (x @ coarse.T)
          + torch.sum(coarse * coarse, -1)[None, :])
    return top_k_smallest(d1, probes)


def _data(t, d, k1, seed, hi=None):
    g = torch.Generator().manual_seed(seed)
    if hi is not None:                      # integers: many exact ties
        return (torch.randint(0, hi, (t, d), generator=g).float(),
                torch.randint(0, hi, (k1, d), generator=g).float())
    return (torch.randn((t, d), generator=g) * 30 + 5,
            torch.randn((k1, d), generator=g) * 30)


@pytest.mark.parametrize("t,d,k1,p,hi", [
    (500, 16, 16, 16, None), (700, 128, 1024, 8, None), (300, 36, 100, 1, 4),
    (257, 128, 1024, 8, 256), (0, 16, 40, 4, None), (64, 20, 5000, 17, 3)])
def test_twin_is_the_former_selection(t, d, k1, p, hi):
    """Values and cells bitwise those of the former inline selection,
    inside the card's shapes (K1 5,000 among them) and outside them
    (P 17)."""
    x, c = _data(t, d, k1, t + d, hi)
    got, want = V.vocab_coarse_plain(x, c, p), _former(x, c, p)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int64


@pytest.mark.parametrize("d,k1,p,ok", [
    (128, 1024, 8, True), (128, 1024, 16, True), (16, 16, 16, True),
    (4, 1, 1, True), (128, 4096, 1, True), (20, 100, 8, True),
    (132, 1024, 8, False), (126, 1024, 8, True), (0, 16, 1, False),
    (128, 100_000, 8, True), (128, 7, 8, False), (128, 1024, 17, False),
    (128, 1024, 0, False)])
def test_shape_ok(d, k1, p, ok):
    """The card takes the cell's shape (D 128, K1 1,024, P 8), the tests'
    K1 16, any D up to 128 (a multiple of 4 or not: the wrapper pads x)
    and any K1 from P up; D past 128 or P past 16 or K1 it refuses."""
    assert V.shape_ok(d, k1, p) is ok


@pytest.mark.parametrize("d,probes", [(16, 3), (18, 3), (16, 17), (130, 3)])
def test_hier_assign_chunk_dispatch(d, probes, monkeypatch):
    """`_hier_assign_chunk` on the CPU goes through the wrapper at every
    shape, those the card refuses too (its twin: no library loaded, no
    launch, `.rows` moved by T), and gives the former selection's words
    and distances."""
    def refuse():
        raise AssertionError("the CPU path must not load the kernels")
    monkeypatch.setattr(_build, "load", refuse)
    g = torch.Generator().manual_seed(d + probes)
    x = torch.randn((900, d), generator=g) * 10
    coarse = torch.randn((20, d), generator=g) * 10
    fine = torch.randn((20, 8, d), generator=g) * 10
    launches, rows = V.vocab_coarse.launches, V.vocab_coarse.rows
    w, dist = K._hier_assign_chunk(x, coarse, fine, probes)
    assert V.vocab_coarse.launches == launches
    assert V.vocab_coarse.rows == rows + 900
    monkeypatch.setattr(V, "vocab_coarse", _former)
    want = K._hier_assign_chunk(x, coarse, fine, probes)
    assert torch.equal(w, want[0]) and torch.equal(dist, want[1])


def test_hierarchical_assign_counts_every_chunk():
    """`.rows` moves by every point of every chunk; no launch on the
    CPU."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn((3000, 32), generator=g)
    coarse, fine = torch.randn((8, 32), generator=g), torch.randn(
        (8, 8, 32), generator=g)
    launches, rows = V.vocab_coarse.launches, V.vocab_coarse.rows
    K.hierarchical_assign(x, coarse, fine, probes=4, chunk=700)
    assert (V.vocab_coarse.launches, V.vocab_coarse.rows) == (
        launches, rows + 3000)


@pytest.mark.parametrize("d,scale,shift", [(128, 60.0, 100.0), (16, 1.0, 0.0),
                                           (100, 1e3, -3e3)])
def test_sum_bound_holds(d, scale, shift):
    """Float32 distances (the twin's, and a sequential float32 sum's)
    lie within half `sum_bound` of the exact float64 ones, each side's
    share of the bound."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn((400, d), generator=g) * scale + shift
    c = torch.randn((300, d), generator=g) * scale
    xd, cd = x.double(), c.double()
    exact = ((xd * xd).sum(-1, keepdim=True) - 2.0 * xd @ cd.T
             + (cd * cd).sum(-1)[None, :])
    half = V.sum_bound(x, c)[:, None] / 2
    twin = ((x * x).sum(-1, keepdim=True) - 2.0 * (x @ c.T)
            + (c * c).sum(-1)[None, :])
    dot = torch.zeros((400, 300))
    for k in range(d):                       # one rounding a term
        dot = dot + x[:, k:k + 1] * c[None, :, k]
    seq = ((x * x).sum(-1, keepdim=True) - 2.0 * dot) + (c * c).sum(-1)
    for got in (twin, seq):
        assert bool(((got.double() - exact).abs() <= half).all())


def test_compare_holds_the_twin_and_catches_a_wrong_kernel(monkeypatch):
    """On the CPU the comparison holds the twin against itself (0 apart,
    near ties counted); a kernel that swaps two cells far apart, or moves
    a distance past the bound, raises."""
    x, c = _data(2000, 128, 1024, 9)
    out = V.compare_coarse_kernel((x, c, 8))
    assert out["max_abs_err"] == 0 and out["rows_differ"] == 0
    assert out["rows"] == 2000 and 0 <= out["near_rows"] < 2000
    plain = V.vocab_coarse_plain

    def swapped(x, c, p):
        d, i = plain(x, c, p)
        return d, i[:, [1, 0, *range(2, p)]]

    def moved(x, c, p):
        d, i = plain(x, c, p)
        return d + 2 * V.sum_bound(x, c).float()[:, None], i
    for wrong in (swapped, moved):
        monkeypatch.setattr(V, "vocab_coarse", wrong)
        with pytest.raises(AssertionError, match="summation bound"):
            V.compare_coarse_kernel((x, c, 8))
