"""Whole runs of the harness at a size the CPU holds: the reference
against the port, the faults and the controls that `correct` must catch,
and a cell and a metric added as files alone. Card tests run the cells on
the card at a reduced size."""

import hashlib
import json
import os
import shutil

import numpy as np
import pytest
import torch

from conftest import ROOT, TINY
from benchmark import data, harness
from benchmark.reference import adc, compare, control

FLAT = "sift1m-opq8.b256"
IVF = "sift1m-ivf8192-pq16.b4096-np16"
SEED = 2 ** 31 + 99


def _run(cell, fault=None, trace=False, root=ROOT, seconds=1.0):
    return harness.run_cell(cell, SEED, seconds, trace, device="cpu",
                            overrides=TINY, fault=fault, root=root)


def _inputs(kind, n=8192):
    cfg = {"n": n, "dim": 128, "quantizer": dict(
        kind=kind, m=8 if kind == "opq" else 16, k=256, train_rows=4096,
        iters=5, coarse_k=64, coarse_iters=5)}
    inputs, _ = harness.make_inputs(cfg, 5, torch.device("cpu"))
    return inputs, data.query_pool(5, n, 128, 256, "cpu")


def test_reference_against_the_ports_scan_engine():
    from cvt_tpu_torch.index.flat_adc import FlatADCIndex
    from cvt_tpu_torch.quant.opq import OPQ
    from cvt_tpu_torch.quant.pq import ProductQuantizer
    inputs, q = _inputs("opq")
    idx = FlatADCIndex(OPQ(inputs["rotation"],
                           ProductQuantizer(inputs["codebooks"])),
                       impl="scan", device="cpu")
    idx.add(inputs["base"])
    d, i = idx.search(q, 10)
    ref = adc.FlatADC(inputs["base"], inputs["rotation"],
                      inputs["codebooks"])
    got = compare.numbers(ref, torch.as_tensor(q), i.long(), d)
    # the port's reference engine rounds codebooks and queries to bf16
    assert got["bad_ids"] == 0
    assert got["top1_gap"] < 0.01 and got["dist_err"] < 0.02


def test_reference_against_the_ports_ivf_engines():
    from cvt_tpu_torch.index.ivf_adc import IVFADCIndex
    from cvt_tpu_torch.quant.pq import ProductQuantizer
    inputs, q = _inputs("ivf")
    idx = IVFADCIndex(coarse_k=64, m=16, k=256, device="cpu")
    idx.centroids = inputs["centroids"]
    idx.pq = ProductQuantizer(inputs["codebooks"])
    idx.build(inputs["base"])
    ref = adc.IVFADC(inputs["base"], inputs["centroids"],
                     inputs["codebooks"])
    qt = torch.as_tensor(q)
    # the reference engine scores the bucket overflow from a bf16 decode
    d, i = idx.search(q, 10, nprobe=16)
    got = compare.numbers(ref, qt, i.long(), d, 16)
    assert got["top1_gap"] < 0.01 and got["dist_err"] < 0.01
    d, i, dropped = idx.search_fast(q, 10, nprobe=16)
    got = compare.numbers(ref, qt, i.long(), d, 16)
    assert int(dropped) == 0
    assert got["top1_gap"] < 1e-3 and got["dist_err"] < 1e-3


@pytest.mark.parametrize("cell", [FLAT, IVF])
def test_a_sound_run_is_correct(cell):
    result, info = _run(cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    e2e = {m["name"] for m in harness.Registry(ROOT).metrics(
        cell, "end_to_end")}
    assert set(result["metrics"]) == e2e


def _roll(d, i):
    """Every query gets the answer of the next query of its batch."""
    return np.roll(d, 1, axis=0), np.roll(i, 1, axis=0)


def _batch_fault(change):
    def fault(system):
        search = system.search

        def broken(q):
            d, i, dropped = search(q)
            d, i = change(d, i)
            return d, i, dropped
        system.search = broken
    return fault


FAULTS = {
    "answers of another query": _roll,
    "distances scaled": lambda d, i: (d * 1.5, i),
    "ids shifted by one row": lambda d, i: (d, np.where(i >= 0, i + 1, i)),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
@pytest.mark.parametrize("cell", [FLAT, IVF])
def test_an_answer_altered_where_it_is_produced_is_caught(cell, name):
    result, _ = _run(cell, fault=_batch_fault(FAULTS[name]))
    assert not result["correct"], result["checks"]


def _far_ranks(cell):
    """Ranks 2..k replaced by rows far from the query, each with the
    reference's own distance for it: only the ranks are wrong."""
    reg = harness.Registry(ROOT)
    cfg = harness._merge(reg.config(reg.cell(cell)["config"]),
                         TINY["config"])
    inputs, _ = harness.make_inputs(cfg, SEED, torch.device("cpu"))
    ref = harness.reference(cfg, inputs)

    def change(q, d, i):
        k = i.shape[1]
        far = (i[:, :1] + ref.n // 3
               + np.arange(1, k) * (ref.n // (2 * k))) % ref.n
        i = np.concatenate([i[:, :1], far], 1)
        d_far = ref.dists(torch.as_tensor(q), torch.as_tensor(i)).numpy()
        return np.concatenate([d[:, :1], d_far[:, 1:].astype(d.dtype)], 1), i

    def fault(system):
        search = system.search

        def broken(q):
            d, i, dropped = search(q)
            d, i = change(q, d, i)
            return d, i, dropped
        system.search = broken
    return fault


@pytest.mark.parametrize("cell", [FLAT, IVF])
def test_far_rows_below_the_first_answer_are_caught(cell):
    result, _ = _run(cell, fault=_far_ranks(cell))
    checks = result["checks"]
    assert not result["correct"], checks
    # only the ranks are wrong: the first answer and every distance hold
    assert checks["rank_gap"]["value"] > checks["rank_gap"]["limit"]
    assert all(c["value"] <= c["limit"] for n, c in checks.items()
               if n != "rank_gap"), checks


@pytest.mark.parametrize("cell", [FLAT, IVF])
def test_the_control_is_not_correct(cell):
    reg = harness.Registry(ROOT)
    limits = reg.limits(cell)
    kind = reg.config(reg.cell(cell)["config"])["quantizer"]["kind"]
    inputs, q = _inputs(kind)
    qt = torch.as_tensor(q)
    if kind == "opq":
        ref = adc.FlatADC(inputs["base"], inputs["rotation"],
                          inputs["codebooks"])
        d, i = control.flat_int4(ref, qt, 10)
        got = compare.numbers(ref, qt, i, d)
    else:
        ref = adc.IVFADC(inputs["base"], inputs["centroids"],
                         inputs["codebooks"])
        d, i = control.ivf_int8(ref, qt, 10, 16)
        got = compare.numbers(ref, qt, i, d, 16)
    assert any(got[k] > limits[k] for k in ("top1_gap", "rank_gap",
                                            "dist_err")), got


def _digest(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha1(
                open(p, "rb").read()).hexdigest()
    return out


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    (b / "traffic" / "b512.json").write_text(json.dumps(
        {"loop": "closed", "batch": 512, "k": 10, "pool": 262144,
         "keep_per_batch": 1, "sample": 2048}))
    (b / "workloads" / "sift1m-opq8.b512.json").write_text(
        (b / "workloads" / "sift1m-opq8.b256.json").read_text())
    (b / "metrics" / "batches.counted.py").write_text(
        "def read(ctx):\n    return ctx.window.extra.get('batches')\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "sift1m-opq8.b512",
                               "config": "sift1m-opq8", "traffic": "b512",
                               "chips": 1, "why": "a test's cell"})
    bench["per_layer"].append({"name": "batches.counted", "unit": "batches",
                               "better": "higher",
                               "source": "program_counter", "layer": "Test",
                               "moves": "qps",
                               "workloads": ["sift1m-opq8.b512"]})
    next(m for m in bench["end_to_end"] if m["name"] == "qps")[
        "workloads"].append("sift1m-opq8.b512")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    result, info = _run("sift1m-opq8.b512", trace=True, root=str(tmp_path))
    assert result["correct"]
    assert result["metrics"]["batches.counted"]["value"] == info["batches"]
    after = _digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [FLAT, IVF])
def test_cells_on_the_card(card, cell):
    over = {"config": {"n": 131072}, "traffic": {"pool": 65536}}
    for trace in (False, True):
        result, _ = harness.run_cell(cell, SEED, 2.0, trace, device="cuda",
                                     overrides=over)
        assert result["correct"], result["checks"]
        assert result["device"]["platform"] == "gpu"
        if trace:
            assert result["device"]["busy_s"] > 0
            assert result["metrics"]
