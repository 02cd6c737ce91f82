"""`vocab_descend_kernel` (csrc/vocab_descend.cu) on the card against its
plain twin `vocab_descend_plain` (ops/kernels/vocab_descend.py) and the
float32 path it replaces (`_cell_argmin` in ops/kmeans.py), on integer
trees.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_vocab_descend_cuda.py --noconftest -m cuda

Tolerance: none. Every product and sum is an integer below 2^25 in
magnitude: exact in the kernel's int32, the twin's float64 and (below
2^24) the float path's float32, so distances and word ids are bitwise.
"""

import importlib

import numpy as np
import pytest
import torch

from cvt_tpu_torch.ops.kernels import vocab_descend as V

# the module, not `cvt_tpu_torch.ops.kmeans` the function
K = importlib.import_module("cvt_tpu_torch.ops.kmeans")

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tree(k1, k2, d, dev, gen, hi=256):
    return torch.randint(0, hi, (k1, k2, d), generator=gen).to(
        torch.uint8).to(dev)


def _args(rows, cells, words):
    """The wrapper's arguments for pairs of `rows` in `cells` [T, P], as
    `_cell_argmin_u8` makes them."""
    order, tc, r0, cnt = K._pair_tiles(cells, words.shape[0])
    tiles = torch.from_numpy(np.stack([tc, r0, cnt], 1).astype(
        np.int32)).to(rows.device)
    fsq = (words.int() ** 2).sum(-1).int()
    return rows, order, tiles, words, fsq, cells.shape[1]


def _check(rows, cells, words):
    """Kernel against the twin (on the card) and the float path:
    bitwise; the launch and pair counts move by one call's."""
    args = _args(rows, cells, words)
    launches, pairs = V.vocab_descend.launches, V.vocab_descend.pairs
    got_d, got_s = V.vocab_descend(*args)
    torch.cuda.synchronize()
    assert V.vocab_descend.launches == launches + (args[2].shape[0] > 0)
    assert V.vocab_descend.pairs == pairs + cells.numel()
    want_d, want_s = V.vocab_descend_plain(*args)
    assert torch.equal(got_d, want_d) and torch.equal(got_s, want_s)
    fd, fs = K._cell_argmin(rows.float(), cells,
                            K._augmented_fine(words.float()))
    t, p = cells.shape
    assert torch.equal(got_d.float().reshape(t, p), fd)
    assert torch.equal(got_s.long().reshape(t, p), fs)
    return got_d, got_s, args


@pytest.mark.parametrize("k2,d", [(1024, 128), (384, 64), (128, 16),
                                  (256, 48)])
def test_full_tile_and_padded_shapes(card, k2, d):
    """512 pairs of one cell (one full tile, 8 M-tiles), then 513 (a
    second tile of one pair), at the cell's shape and at narrower ones
    (d zero-padded to the k-steps, fewer 128-word chunks)."""
    gen = torch.Generator().manual_seed(k2 + d)
    words = _tree(2, k2, d, card, gen)
    for t in (512, 513):
        rows = torch.randint(0, 256, (t, d), generator=gen).to(
            torch.uint8).to(card)
        cells = torch.ones((t, 1), dtype=torch.int64, device=card)
        _, _, args = _check(rows, cells, words)
        assert args[2].shape[0] == (t + 511) // 512


def test_one_pair_tile(card):
    gen = torch.Generator().manual_seed(1)
    words = _tree(4, 1024, 128, card, gen)
    rows = torch.randint(0, 256, (1, 128), generator=gen).to(
        torch.uint8).to(card)
    _check(rows, torch.tensor([[3]], device=card), words)


def test_cells_without_pairs(card):
    """Pairs in cells 0, 2 and 5 of 8 only; every other cell gets no
    tile, and no pair is missed."""
    gen = torch.Generator().manual_seed(2)
    words = _tree(8, 1024, 128, card, gen)
    rows = torch.randint(0, 256, (3000, 128), generator=gen).to(
        torch.uint8).to(card)
    pick = torch.tensor([0, 2, 5])[torch.randint(0, 3, (3000, 3),
                                                 generator=gen)].to(card)
    _, _, args = _check(rows, pick, words)
    assert set(args[2][:, 0].tolist()) == {0, 2, 5}


def test_no_pairs_launches_nothing(card):
    words = _tree(2, 128, 16, card, torch.Generator().manual_seed(3))
    rows = torch.zeros((0, 16), dtype=torch.uint8, device=card)
    cells = torch.zeros((0, 2), dtype=torch.int64, device=card)
    launches = V.vocab_descend.launches
    d, s = V.vocab_descend(*_args(rows, cells, words))
    assert d.numel() == 0 and s.numel() == 0
    assert V.vocab_descend.launches == launches


def test_repeated_words_first_minimum_wins(card):
    """Words of 0-3 (many exact ties), a cell of one word repeated and a
    word repeated across the 128-word chunks: the first minimum wins, as
    torch.min takes it."""
    gen = torch.Generator().manual_seed(4)
    words = _tree(3, 1024, 128, card, gen, hi=4)
    words[1] = words[1, 7]
    words[2, 900] = words[2, 3]
    words[2, 129] = words[2, 3]
    rows = torch.randint(0, 4, (2000, 128), generator=gen).to(
        torch.uint8).to(card)
    rows[:50] = words[2, 3]
    cells = torch.randint(0, 3, (2000, 4), generator=gen).to(card)
    cells[:50, 0] = 2
    got_d, got_s, _ = _check(rows, cells, words)
    s = got_s.reshape(2000, 4)
    assert bool((s[:50, 0] == 3).all())
    assert bool((s.reshape(-1)[cells.reshape(-1) == 1] == 0).all())


def test_extreme_magnitudes(card):
    """Rows all 255 against words all 0 and all 255, and rows all 0
    against both: the scores' ends, -255^2 d and 255^2 d."""
    d = 128
    words = torch.zeros((2, 1024, d), dtype=torch.uint8, device=card)
    words[0, 1::2] = 255                    # cell 0: 0, 255, 0, 255, ...
    words[1] = 255                          # cell 1: all 255
    rows = torch.zeros((4, d), dtype=torch.uint8, device=card)
    rows[1::2] = 255
    cells = torch.tensor([[0, 1]] * 4, device=card)
    got_d, got_s, _ = _check(rows, cells, words)
    top = 255 * 255 * d
    assert got_d.reshape(4, 2).tolist() == [[0, top], [-top, -top]] * 2
    assert got_s.reshape(4, 2).tolist() == [[0, 0], [1, 0]] * 2


def test_cell_shape_batch_through_hierarchical_assign(card):
    """One batch at the vocabulary cell's shape: ~206k uint8 rows, 8
    probes over a [1,024, 1,024, 128] integer tree whose words are
    training rows (as the cell's are). The kernel path of
    `hierarchical_assign` against the float path on the same values,
    and the kernel against its twin on the batch's own arguments."""
    gen = torch.Generator(device=card).manual_seed(5)
    k1, k2, d, t = 1024, 1024, 128, 206_000
    centres = torch.randint(0, 256, (4096, d), generator=gen,
                            device=card).float()

    def draw(m):
        c = centres[torch.randint(0, 4096, (m,), generator=gen, device=card)]
        return (c + 20 * torch.randn((m, d), generator=gen, device=card)
                ).clamp(0, 255).round()
    coarse = draw(k1) + 0.37                # float coarse centroids
    fine = draw(k1 * k2).reshape(k1, k2, d)
    rows = draw(t).to(torch.uint8)
    launches, pairs = V.vocab_descend.launches, V.vocab_descend.pairs
    args = []
    V.vocab_descend.recorded = args
    tree = K.integer_tree(fine)
    assert tree is not None
    try:
        w, dist = K.hierarchical_assign(rows.float(), coarse, fine, probes=8,
                                        tree=tree, rows=rows)
    finally:
        V.vocab_descend.recorded = None
    assert V.vocab_descend.launches == launches + 1
    assert V.vocab_descend.pairs == pairs + 8 * t
    wf, df = K.hierarchical_assign(rows.float(), coarse, fine, probes=8)
    assert torch.equal(w, wf) and torch.equal(dist, df)
    got = V.vocab_descend(*args[0])
    want = V.vocab_descend_plain(*args[0])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_index_takes_the_kernel_on_an_integer_tree_alone(card):
    """VocabHEIndex on the card: a tree assigned as a plain attribute is
    checked once there; uint8 rows on an integer tree launch the kernel
    once a call, float rows and a float tree that replaces it do not, and
    the words are the float path's in every case."""
    from cvt_tpu_torch.index.vocab_he import VocabHEIndex
    gen = torch.Generator(device=card).manual_seed(6)
    k1, k2, d = 16, 256, 128
    coarse = torch.randint(0, 256, (k1, d), generator=gen,
                           device=card).float() + 0.37
    fine = torch.randint(0, 256, (k1, k2, d), generator=gen,
                         device=card).float()
    rows = torch.randint(0, 256, (5000, d), generator=gen,
                         device=card).to(torch.uint8)
    idx = VocabHEIndex(n_words=k1 * k2, dim=d, hierarchical=True, probes=4,
                       device=card)
    idx.coarse, idx.fine = coarse, fine
    assert idx._tree is not None
    want, _ = K.hierarchical_assign(rows.float(), coarse, fine, probes=4)
    for desc, fires in ((rows, 1), (rows.float(), 0)):
        launches = V.vocab_descend.launches
        assert torch.equal(idx._assign(*idx._stage(desc)), want)
        assert V.vocab_descend.launches == launches + fires
    idx.fine = fine + 0.5
    assert idx._tree is None
    launches = V.vocab_descend.launches
    want, _ = K.hierarchical_assign(rows.float(), coarse, idx.fine, probes=4)
    assert torch.equal(idx._assign(*idx._stage(rows)), want)
    assert V.vocab_descend.launches == launches
