"""The vocabulary-tree cell (`oxford5k-vt1m-he64.q64`, kind `vocab`) at a
size the CPU runs in seconds: a sound run is correct, the faults that
`correct` must catch read false, the control fails its limits, and a
traced run reads the cell's per-layer metrics or nothing."""

import numpy as np
import pytest
import torch

from conftest import ROOT  # noqa: F401  (puts the checkout on the path)
from benchmark import harness

CELL = "oxford5k-vt1m-he64.q64"
SEED = 2 ** 33 + 7
# the cell shrunk: fewer images, rows, words and centres; widths unchanged
SMALL = {"config": {"n_images": 48, "mean_per_image": 200,
                    "tree": {"coarse": 16, "fine": 16, "probes": 4,
                             "train_rows": 8192, "coarse_sample": 4096,
                             "coarse_iters": 3},
                    "data": {"centres": 512, "scene_rows": 256,
                             "count_min": 32, "count_max": 1000}},
         "traffic": {"batch": 8, "pool": 48, "sample": 32}}


def _run(fault=None, trace=False, after=None):
    return harness.run_cell(CELL, SEED, 1.0, trace, device="cpu",
                            overrides=SMALL, fault=fault, after=after)


def _shift_ids(system):
    search = system.search

    def broken(batch):
        s, i, dropped = search(batch)
        return s, np.roll(i, 1, axis=0), dropped
    system.search = broken


def _scale_scores(system):
    search = system.search

    def broken(batch):
        s, i, dropped = search(batch)
        return s * 1.5, i, dropped
    system.search = broken


def _drop_he_weights(system):
    # every pair within the Hamming limit weighs 1
    system.index._wtab = torch.ones_like(system.index._wtab)


def test_a_sound_run_is_correct():
    result, info = _run()
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert info["self_at_1"] == 1.0
    assert info["pairs_per_batch"] > 0 and info["longest_list"] > 0
    assert set(result["metrics"]) == {"qps", "setup_s"}


@pytest.mark.parametrize("fault", [_shift_ids, _scale_scores,
                                   _drop_he_weights])
def test_a_broken_run_is_not_correct(fault):
    result, _ = _run(fault)
    assert not result["correct"], result["checks"]


def test_the_control_fails_its_limits():
    reg = harness.Registry()
    cfg = harness._merge(reg.config("oxford5k-vt1m-he64"), SMALL["config"])
    traffic = harness._merge(reg.traffic("q64"), SMALL["traffic"])
    kind = reg.kind("vocab")
    limits = reg.limits(CELL)

    def after(ref, pool, win, dev):
        return kind.control(ref, cfg, traffic, pool, win, dev)
    result, info = _run(after=after)
    assert result["correct"]
    assert any(info["after"][k] > lim for k, lim in limits.items())
    # the projection and term weights alone in bfloat16 fail them too
    assert info["after"]["signing_score_err_med"] > limits["score_err_med"]


def test_a_traced_run_reads_the_cells_metrics():
    result, _ = _run(trace=True)
    assert result["correct"], result["checks"]
    # on the CPU no operation runs on a device: the span reader finds
    # its spans and reads 0; the kernel's roofline finds no kernel
    assert result["metrics"]["assign_ms.batch"]["value"] == 0.0
    assert result["metrics"]["search_rest_ms.batch"]["value"] == 0.0
    assert "vocab_score_roofline" not in result["metrics"]


def test_span_pairing_counts_a_driver_api_launch():
    """Two batches of three launches each; the second's kernel launched
    through the driver API (`cuLaunchKernel`), and the slice's first
    operation lost by the profiler."""
    from benchmark import vocab_spans
    from benchmark.trace import Event
    ev = [Event("vocab.search", False, 0.0, 10.0),
          Event("vocab.assign", False, 1.0, 5.0),
          Event("vocab.search", False, 20.0, 30.0),
          Event("vocab.assign", False, 21.0, 25.0)]
    for t0, driver in ((0.0, False), (20.0, True)):
        ev += [Event("cudaMemcpyAsync", False, t0 + 0.5, t0 + 0.6),
               Event("cuLaunchKernel" if driver else "cudaLaunchKernel",
                     False, t0 + 2.0, t0 + 2.1),
               Event("cudaLaunchKernel", False, t0 + 6.0, t0 + 6.1)]
        ev += [Event("Memcpy HtoD", True, t0 + 0.7, t0 + 1.7),
               Event("gemm", True, t0 + 2.2, t0 + 4.2),
               Event("topk", True, t0 + 6.2, t0 + 6.7)]
    ev = [e for e in ev if not (e.device and e.start == 0.7)]
    got = vocab_spans.split(ev, (0.0, 40.0))
    assert got.batches == 2
    assert got.device_ms_per_batch(("vocab.assign",)) == pytest.approx(2e3)


def test_the_pool_slices_by_image():
    reg = harness.Registry()
    cfg = harness._merge(reg.config("oxford5k-vt1m-he64"), SMALL["config"])
    traffic = harness._merge(reg.traffic("q64"), SMALL["traffic"])
    kind = reg.kind("vocab")
    pool = kind.query_pool(cfg, traffic, SEED, "cpu")
    desc, counts = kind.database(cfg, SEED, "cpu")
    assert pool.shape == (48,) and desc.dtype == torch.uint8
    b = pool[8:16]
    assert b.rows.base is not None          # a view, no copy
    a = int(counts[:8].sum())
    np.testing.assert_array_equal(b.rows, desc[a:a + counts[8:16].sum()])
    np.testing.assert_array_equal(b.counts, counts[8:16])
