"""The spatially verified vocabulary-tree cell
(`oxford5k-vt1m-he64-sv100.q64`, kind `vocab_sv`) at a size the CPU runs
in seconds: the kind's five functions, a sound run correct, the faults
that `correct` must catch read false (verification dropped, the 1-to-1
rule dropped, another query's frames), the controls fail their limits,
and a traced run reads the cell's metrics or nothing."""

import numpy as np
import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import harness
from benchmark.trace import Event

CELL = "oxford5k-vt1m-he64-sv100.q64"
SEED = 2 ** 33 + 11
# the cell shrunk: fewer images, rows, words, centres and candidates;
# widths unchanged
SMALL = {"config": {"n_images": 48, "mean_per_image": 200, "verify": 10,
                    "tree": {"coarse": 16, "fine": 16, "probes": 4,
                             "train_rows": 8192, "coarse_sample": 4096,
                             "coarse_iters": 3},
                    "data": {"centres": 512, "scene_rows": 256,
                             "count_min": 32, "count_max": 1000}},
         "traffic": {"batch": 8, "pool": 48, "sample": 32, "k": 10}}


def _setup():
    reg = harness.Registry()
    cfg = harness._merge(reg.config("oxford5k-vt1m-he64-sv100"),
                         SMALL["config"])
    traffic = harness._merge(reg.traffic("q64"), SMALL["traffic"])
    return reg, cfg, traffic, reg.kind("vocab_sv")


def _run(fault=None, trace=False, after=None):
    return harness.run_cell(CELL, SEED, 1.0, trace, device="cpu",
                            overrides=SMALL, fault=fault, after=after)


def test_the_kinds_functions():
    reg, cfg, traffic, kind = _setup()
    inputs, info = kind.inputs(cfg, SEED, "cpu")
    n = int(inputs["counts"].sum())
    assert inputs["frames"].shape == (n, 4) and info["descriptors"] == n
    again, _ = kind.inputs(cfg, SEED, "cpu")
    assert torch.equal(again["frames"], inputs["frames"])
    assert torch.equal(again["descriptors"], inputs["descriptors"])
    pool = kind.query_pool(cfg, traffic, SEED, "cpu")
    b = pool[8:16]
    a = int(inputs["counts"][:8].sum())
    m = int(inputs["counts"][8:16].sum())
    np.testing.assert_array_equal(b.frames, inputs["frames"][a:a + m])
    np.testing.assert_array_equal(b.rows, inputs["descriptors"][a:a + m])
    assert b.frames.base is not None                  # a view, no copy
    ref = kind.reference(cfg, inputs)
    cands = ref.candidates(torch.tensor([0, 9]))
    assert cands.shape == (2, 10) and cands[:, 0].tolist() == [0, 9]
    eff = ref.pair_inliers(9, cands[1])
    # the image against itself: every feature its own inlier; its group
    # (8 images) sees one scene
    assert float(eff[0]) > 10
    same = (cands[1] // 8 == 1) & (cands[1] != 9)
    assert float(eff[same].min()) > float(eff[~same & (cands[1] != 9)].max())


def test_a_sound_run_is_correct():
    result, info = _run()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert info["self_at_1"] == 1.0
    assert info["records_per_batch"] > 0 and info["verified_pairs"] > 0
    assert info["inliers_same_group_med"] > info["inliers_other_med"]
    assert set(result["metrics"]) == {"qps", "setup_s"}


def _no_verification(system):
    system.verify = 0


def _another_querys_frames(system):
    search = system.search

    def broken(batch):
        # another query's frames: the batch's frames rolled by one image
        batch.frames = np.roll(batch.frames, int(batch.counts[0]), axis=0)
        return search(batch)
    system.search = broken


@pytest.mark.parametrize("fault", [_no_verification,
                                   _another_querys_frames])
def test_a_broken_run_is_not_correct(fault):
    result, _ = _run(fault)
    assert not result["correct"], result["checks"]


def test_dropping_the_one_to_one_rule_is_not_correct(monkeypatch):
    from cvt_tpu_torch.index import vocab_he

    def every_record(rec, n_feat, n_db):
        r = rec.long()
        order = torch.argsort(r[:, 0] * n_feat + r[:, 1], stable=True)
        return r[order, 0], r[order, 1], r[order, 2]
    monkeypatch.setattr(vocab_he, "_one_to_one", every_record)
    result, _ = _run()
    assert not result["correct"], result["checks"]


def test_the_control_fails_its_limits():
    reg, cfg, traffic, kind = _setup()
    limits = reg.limits(CELL)

    def after(ref, pool, win, dev):
        return kind.control(ref, cfg, traffic, pool, win, dev)
    result, info = _run(after=after)
    assert result["correct"]
    assert any(info["after"][k] > lim for k, lim in limits.items())
    # the signing control moves every score a little: both medians
    for k in ("score_err_med", "inlier_gap_med"):
        assert info["after"]["signing_" + k] > limits[k]


def test_a_traced_run_reads_the_cells_metrics():
    result, _ = _run(trace=True)
    assert result["correct"], result["checks"]
    # on the CPU no operation runs on a device: the span readers find
    # their spans and read 0; the kernel's roofline finds no kernel
    assert result["metrics"]["verify_ms.batch"]["value"] == 0.0
    assert result["metrics"]["assign_ms.batch"]["value"] == 0.0
    for name in ("vocab_match_roofline", "vocab_score_roofline",
                 "descend_kernel_ms.batch"):
        assert name not in result["metrics"]


def test_verify_ms_reads_the_three_spans_and_nothing_else():
    from types import SimpleNamespace
    reader = harness.Registry().reader("verify_ms.batch")
    ev = [Event("vocab.search", False, 0.0, 10.0),
          Event("vocab.assign", False, 1.0, 2.0),
          Event("vocab.verify", False, 3.0, 9.0),
          Event("vocab.match", False, 4.0, 5.0),
          Event("vocab.vote", False, 6.0, 7.0)]
    for t0 in (1.5, 3.2, 4.5, 6.5):
        ev.append(Event("cudaLaunchKernel", False, t0, t0 + 0.01))
    for t0 in (1.6, 3.3, 4.6, 6.6):
        ev.append(Event("k", True, t0, t0 + 0.25))
    ctx = SimpleNamespace(events=ev, slice=(0.0, 20.0), traced_calls=1)
    assert reader.read(ctx) == pytest.approx(750.0)
    ev = [e for e in ev if not e.name.startswith(("vocab.verify",
                                                  "vocab.match",
                                                  "vocab.vote"))]
    ctx = SimpleNamespace(events=ev, slice=(0.0, 20.0), traced_calls=1)
    assert reader.read(ctx) is None


def test_the_rooflines_bytes():
    reg = harness.Registry()
    work = reg.roofline("vocab_match").work
    assert work(10, 4, 3, 2, 5, 7) == (0.0, 4 * 10 + 12 * 4 + 12 * 3
                                       + 4 * 2 * 5 + 16 * 7)


def test_candidate_entries_by_a_plain_walk():
    """The entries the roofline reads in full: those of a walked list
    whose image is a candidate of a query that walks it, counted once,
    against a set built entry by entry."""
    reg, cfg, traffic, kind = _setup()
    inputs, _ = kind.inputs(cfg, SEED, "cpu")
    ref = kind.reference(cfg, inputs)
    b = ref.base
    images = torch.tensor([0, 3, 9, 17])
    cands = ref.candidates(images)
    want = set()
    for j, q in enumerate(images.tolist()):
        words = set(b.words[b.img_off[q]:b.img_off[q + 1]].tolist())
        for c in cands[j].tolist():
            for r in range(int(b.img_off[c]), int(b.img_off[c + 1])):
                if int(b.words[r]) in words:
                    want.add(r)
    got = ref.candidate_entries(images, cands)
    assert got == len(want) > 0
    assert got < ref.distinct_entries(images)
    assert ref.n_images == b.n_images
