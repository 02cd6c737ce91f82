"""`vocab_match_kernel` (csrc/vocab_match.cu) on the card against its plain
twin `vocab_match_plain` (ops/kernels/vocab_match.py), and the ragged
verified query (`VocabHEIndex.query_batch(..., verify=)`) on the card
against the same query on the CPU.

Marked `cuda`: every test takes the `card` fixture, which skips when
torch.cuda.is_available() is false (decided in the fixture, never at
import). Needs no JAX:
    python -m pytest tests/test_torch_vocab_match_cuda.py --noconftest -m cuda

The kernel's records are the twin's, once each, in the order its atomics
land: compared sorted (`compare_match_kernel`), no tolerance. The card's
and the CPU's verified queries share the words, signatures and matches
bit for bit; their vote parameters go through transcendental functions
(log2, atan2, sin, cos) that round differently on the two devices, so a
match may fall into another bin and a verification part move: ids equal
where the CPU's neighbouring scores stand more than 2 apart, and the
verification parts equal on all but a hundredth of the pairs.
"""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.kinds import vocab_sv as kind_sv
from cvt_tpu_torch.index import VocabHEIndex
from cvt_tpu_torch.ops.kernels import (recorded_args, twin_check,
                                       vocab_match as VM)

pytestmark = pytest.mark.cuda
CELL = "oxford5k-vt1m-he64-sv100.q64"
SEED = 2 ** 32 + 5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lists(lengths, n_images, dev, gen):
    lengths = torch.as_tensor(lengths, dtype=torch.int64)
    off = torch.zeros(len(lengths) + 1, dtype=torch.int64)
    off[1:] = torch.cumsum(lengths, 0)
    e = int(off[-1])
    img = torch.randint(0, n_images, (e,), generator=gen, dtype=torch.int32)
    sig = torch.randint(-2 ** 63, 2 ** 63 - 1, (e,), generator=gen,
                        dtype=torch.int64)
    feat = torch.randperm(e, generator=gen).int()
    return [t.to(dev) for t in (off, img, sig, feat)]


def _near(sig, gen, bits):
    out = sig.clone()
    for _ in range(bits):
        b = torch.randint(0, 64, sig.shape, generator=gen)
        flip = torch.where(b == 63, torch.tensor(-2 ** 63),
                           torch.tensor(1) << b.clamp_max(62))
        out = out ^ flip
    return out


def _cand(q, n_images, c, dev, gen):
    cand = torch.full((q, n_images), -1, dtype=torch.int32)
    for j in range(q):
        pick = torch.randperm(n_images, generator=gen)[:c]
        cand[j, pick] = torch.arange(c, dtype=torch.int32) + c * j
    return cand.to(dev)


def _same(args):
    before = VM.vocab_match.counters()
    out = twin_check("vocab_match", args)
    assert VM.vocab_match.counters() == before
    return out


@pytest.fixture(scope="module")
def cell_index():
    """The cell's index built from the benchmark's own files on the card,
    one batch of the traffic and the CPU-free pool."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    reg = harness.Registry()
    cell = reg.cell(CELL)
    cfg, traffic = reg.config(cell["config"]), reg.traffic(cell["traffic"])
    kind = reg.kind("vocab_sv")
    inputs, _ = kind.inputs(cfg, SEED, dev)
    pool = kind.query_pool(cfg, traffic, SEED, dev)
    system = reg.system(cfg["index"]).System(cfg, inputs, traffic, dev)
    return system, pool[64:64 + traffic["batch"]]


def test_at_the_cells_batch(card, cell_index):
    """The arguments one batch of the cell hands the wrapper: the
    kernel's records are the twin's; one launch once the index has room
    for them; the counters count the batch."""
    system, batch = cell_index
    system.search(batch)                                      # warm
    before = VM.vocab_match.counters()
    args = recorded_args("vocab_match", lambda: system.search(batch))
    after = VM.vocab_match.counters()
    assert after["launches"] - before["launches"] == 1
    assert after["pairs"] - before["pairs"] == int(
        VM._lengths(args[0], args[3]).sum())
    assert after["pairs"] - before["pairs"] > 10_000_000
    out = _same(args)
    assert out["records"] == after["matches"] - before["matches"] > 100_000


def test_a_long_list_and_repeated_words(card):
    """One list of 100,003 entries (many blocks' worth of threads), empty
    lists, features with no word, and one word repeated by many
    features of one query."""
    gen = torch.Generator().manual_seed(4)
    lengths = [0, 100_003, 0, 5, 0, 0, 1, 300]
    off, img, sig, feat = _lists(lengths, 97, card, gen)
    w = torch.tensor([1, 0, 2, -1, 1, 3, 4, 7, -1, 6] + [1] * 40,
                     dtype=torch.int32)
    f_query = torch.tensor([0, 0, 0, 1, 1, 1, 2, 2, 2, 3] + [3] * 40,
                           dtype=torch.int32)
    src = sig.cpu()[off.cpu()[w.clamp_min(0).long()].clamp_max(
        len(sig) - 1)]
    f_sig = _near(src, gen, 3)
    cand = _cand(4, 97, 30, card, gen)
    args = (w.to(card), f_sig.to(card), f_query.to(card), off, img, sig,
            feat, cand, 24, 1 << 20)
    assert _same(args)["records"] > 0
    # a capacity too small: a second launch with room for all
    before = VM.vocab_match.launches
    got = VM.vocab_match(*args[:-1], 1)
    assert VM.vocab_match.launches - before == 2
    assert torch.equal(VM.sorted_records(got.cpu()), VM.sorted_records(
        VM.vocab_match_plain(*(a.cpu() if torch.is_tensor(a) else a
                               for a in args))))
    # every feature without a list, and no candidate: no record
    none = (torch.tensor([0, 2, -1], dtype=torch.int32).to(card),
            f_sig[:3].to(card), torch.zeros(3, dtype=torch.int32,
                                            device=card))
    assert VM.vocab_match(*none, off, img, sig, feat, cand, 24).shape == (
        0, 4)
    empty = torch.full_like(cand, -1)
    assert VM.vocab_match(*args[:7], empty, 24).shape == (0, 4)


@pytest.mark.parametrize("max_dist", [0, 24, 64])
def test_hamming_limits(card, max_dist):
    gen = torch.Generator().manual_seed(5 + max_dist)
    off, img, sig, feat = _lists([400, 2_000, 7, 90], 13, card, gen)
    w = torch.randint(0, 4, (300,), generator=gen, dtype=torch.int32)
    f_query = torch.randint(0, 5, (300,), generator=gen, dtype=torch.int32)
    f_sig = _near(sig.cpu()[off.cpu()[w.long()]], gen, 12)
    args = (w.to(card), f_sig.to(card), f_query.to(card), off, img, sig,
            feat, _cand(5, 13, 6, card, gen), max_dist, 1 << 20)
    _same(args)


def _shrunk():
    cfg = harness._merge(harness.Registry().config(
        "oxford5k-vt1m-he64-sv100"), {
            "n_images": 96, "mean_per_image": 400,
            "tree": {"coarse": 64, "fine": 64, "probes": 8,
                     "train_rows": 65536, "coarse_sample": 16384,
                     "coarse_iters": 3},
            "data": {"centres": 2048, "scene_rows": 1024,
                     "count_min": 64, "count_max": 2000}})
    return cfg


def _index(cfg, inputs, dev):
    t = cfg["tree"]
    idx = VocabHEIndex(n_words=t["coarse"] * t["fine"], dim=cfg["dim"],
                       hierarchical=True, probes=t["probes"], device=dev)
    idx.coarse, idx.fine = inputs["coarse"].to(dev), inputs["fine"].to(dev)
    idx.words = idx.fine.reshape(-1, cfg["dim"])
    idx.he_proj = inputs["he_proj"].to(dev)
    idx.he_thresh = inputs["he_thresh"].to(dev)
    idx.add_images(inputs["descriptors"].to(dev), inputs["counts"],
                   geometries=inputs["frames"])
    idx.prepare()
    return idx


def test_ragged_verified_query_card_against_cpu(card):
    cfg = _shrunk()
    inputs, _ = kind_sv.inputs(cfg, SEED, "cpu")
    gpu, cpu = _index(cfg, inputs, card), _index(cfg, inputs, "cpu")
    off = np.concatenate([[0], np.cumsum(inputs["counts"])])
    images = list(range(8, 40))
    rows = np.concatenate([np.arange(off[i], off[i + 1]) for i in images])
    counts = inputs["counts"][images]
    kw = dict(counts=counts, geometries=inputs["frames"][rows], verify=24,
              topk=24)
    d = inputs["descriptors"][rows]
    ids_g, sc_g, _ = gpu.query_batch(d, **kw)
    ids_c, sc_c, _ = cpu.query_batch(d, **kw)
    assert ids_g[:, 0].tolist() == images == ids_c[:, 0].tolist()
    base_g, bsc_g, _ = gpu.query_batch(d, counts=counts, topk=gpu.n_images)
    base_c, bsc_c, _ = cpu.query_batch(d, counts=counts, topk=cpu.n_images)
    np.testing.assert_array_equal(base_g, base_c)
    np.testing.assert_allclose(bsc_g, bsc_c, rtol=1e-6, atol=1e-7)
    unver = np.zeros((len(images), cpu.n_images), np.float32)
    np.put_along_axis(unver, base_c, bsc_c, 1)
    eff_g = dict(((j, i), e) for j in range(len(images)) for i, e in zip(
        ids_g[j], sc_g[j] - np.take_along_axis(unver, ids_g, 1)[j]))
    eff_c = dict(((j, i), e) for j in range(len(images)) for i, e in zip(
        ids_c[j], sc_c[j] - np.take_along_axis(unver, ids_c, 1)[j]))
    common = set(eff_g) & set(eff_c)
    assert len(common) >= 0.95 * len(eff_c)
    differ = sum(abs(eff_g[k] - eff_c[k]) > 1e-3 for k in common)
    assert differ <= len(common) // 100
    for j in range(len(images)):
        gaps = np.abs(np.diff(sc_c[j]))
        for r in range(ids_c.shape[1]):
            sep = min(gaps[r - 1] if r else np.inf,
                      gaps[r] if r < len(gaps) else np.inf)
            if sep > 2.0 + 1e-3:
                assert ids_g[j, r] == ids_c[j, r], (j, r)
