"""The port's north-star benchmark (`cvt_tpu_torch.bench`, `cli bench`) on
the CPU at small sizes; its kernels run their plain twins here.

(a) An OPQ trained by cvt_tpu (N 4,096) carried across: the recall lane
    and the exact lane give cvt_tpu's FlatADCIndex.search ids bitwise
    (fast and exact=True) on the same codes; the reference-engine ids
    equal cvt_tpu's `_adc_scan` except top-1 near-ties (ADC distances
    within 1e-3 relative, as tests/test_torch_flat_adc.py excuses them).
    Recall figures equal where the ids are.
(b) `main` at tiny sizes prints a line per lane and a last line with
    every key of bench.py's object but `vs_baseline` and
    `tflops_effective`, plus the port's keys.
(c) `cli bench --device cpu` in-process.
The bound arithmetic: `adc_bound` at 1M x 8,192 reads 1.076 ms.
"""

import ast
import json
import os

import jax
import numpy as np
import pytest
import torch

from cvt_tpu.index import FlatADCIndex as JFlatADCIndex
from cvt_tpu.index import flat_adc as jflat_adc
from cvt_tpu.quant import OPQ as JOPQ
from cvt_tpu.utils import recall_at_k as jrecall_at_k
from cvt_tpu_torch import bench
from cvt_tpu_torch.convert import flat_adc_from_numpy
from cvt_tpu_torch.ops.kernels import wrappers
from cvt_tpu_torch.utils.profile import adc_bound

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DROPPED = {"vs_baseline", "tflops_effective"}
ADDED = {"int8_tops_effective", "bound_ms", "bound_share", "value_spread",
         "qps_decoded_cache_spread", "qps_exact_spread",
         "sq_d64_qps_spread", "sq_d128_qps_spread",
         "ingest_codes_per_sec_u8_spread", "device", "kernel_launches"}


def _reference_keys() -> set:
    """The keys of the object bench.py prints last (its json.dumps)."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    dicts = [n.args[0] for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "attr", "") == "dumps"
             and n.args and isinstance(n.args[0], ast.Dict)]
    assert len(dicts) == 1
    return {k.value for k in dicts[0].keys}


@pytest.fixture(scope="module")
def carried(sift_like):
    base, queries = sift_like
    jopq = JOPQ.train(jax.random.key(0), base, m=bench.M, k=bench.KSUB,
                      opq_iters=2, kmeans_iters=3, final_kmeans_iters=3)
    jidx = JFlatADCIndex(jopq, impl="pallas")
    jidx.add(base)
    jidx._materialize()
    idx = flat_adc_from_numpy(np.asarray(jidx._codes),
                              np.asarray(jidx._dec_sq),
                              np.asarray(jopq.pq.codebooks),
                              np.asarray(jopq.rotation), device="cpu",
                              impl="kernel")
    gt1 = bench.ground_truth(base, queries, len(queries),
                             torch.device("cpu"))
    return jopq, jidx, idx, queries, gt1


def _adc_dist(jopq, jidx, queries, ids):
    """Float64 ADC distance of each query's top-1 id."""
    cb = np.asarray(jopq.pq.codebooks, np.float64)
    codes = np.asarray(jidx._codes)[ids]                        # [B, M]
    m, _, ds = cb.shape
    dec = cb[np.arange(m)[None], codes].reshape(len(ids), m * ds)
    qr = np.asarray(jopq.rotate(queries), np.float64)
    return ((qr - dec) ** 2).sum(-1)


def test_recall_lane_matches_reference(carried):
    jopq, jidx, idx, queries, gt1 = carried
    got = bench.recall(idx, queries, gt1)
    _, ji = jidx.search(queries, bench.K)
    np.testing.assert_array_equal(got["_ids_fast"].numpy(), np.asarray(ji))
    assert got["recall_at_1"] == jrecall_at_k(np.asarray(ji), gt1, k=1)
    assert got["recall_at_10"] == jrecall_at_k(np.asarray(ji), gt1, k=10)
    # the independent f32 LUT engine against cvt_tpu's on the same codes
    n = jidx.ntotal
    npad = -(-n // bench.REF_CHUNK) * bench.REF_CHUNK
    codes = np.zeros((npad, bench.M), np.uint8)
    codes[:n] = np.asarray(jidx._codes)
    dsq = np.zeros(npad, np.float32)
    dsq[:n] = np.asarray(jidx._dec_sq)
    qr = jopq.rotate(queries)
    _, jr = jflat_adc._adc_scan(qr, jax.numpy.sum(qr * qr, -1), codes, dsq,
                                jopq.pq.codebooks, bench.K, bench.REF_CHUNK,
                                n)
    ref, jr = got["_ids_ref"].numpy(), np.asarray(jr)
    diff = ref[:, 0] != jr[:, 0]
    assert diff.mean() <= 0.1
    np.testing.assert_allclose(_adc_dist(jopq, jidx, queries[diff],
                                         ref[diff, 0]),
                               _adc_dist(jopq, jidx, queries[diff],
                                         jr[diff, 0]), rtol=1e-3)
    if not diff.any():
        assert got["recall_at_1_ref_f32_adc"] == jrecall_at_k(jr, gt1, k=1)
    assert got["recall_parity_pt"] == pytest.approx(
        100 * (got["recall_at_1_ref_f32_adc"] - got["recall_at_1"]))


def test_exact_lane_matches_reference(carried):
    _, jidx, idx, queries, gt1 = carried
    stack = bench.query_stack(idx, queries, len(queries), 1)
    got = bench.exact_lane(idx, stack, queries, gt1)
    _, ji = jidx.search(queries, bench.K, exact=True)
    np.testing.assert_array_equal(got["_ids_exact"].numpy(), np.asarray(ji))
    assert got["recall_at_1_exact"] == jrecall_at_k(np.asarray(ji), gt1,
                                                    k=1)
    assert got["recall_at_10_exact"] == jrecall_at_k(np.asarray(ji), gt1,
                                                     k=10)
    assert got["qps_exact"] > 0 and len(got["qps_exact_spread"]) == 2


def _lines(out: str):
    rows = [json.loads(line) for line in out.strip().splitlines()]
    return rows[:-1], rows[-1]


def _check_result(lanes, last):
    assert [r["lane"] for r in lanes] == list(bench.LANES)
    assert (_reference_keys() - DROPPED) | ADDED <= set(last)
    assert not DROPPED & set(last)
    assert last["device"] == "cpu"
    assert last["kernel_launches"] == {name: 0 for name in wrappers()}
    assert last["bound_by"] == "operations" and last["bound_share"] is None
    lo, hi = last["value_spread"]
    assert lo <= last["value"] <= hi
    lo, hi = last["ingest_codes_per_sec_u8_spread"]
    assert lo <= last["ingest_codes_per_sec_u8"] <= hi
    assert 0.0 <= last["recall_at_1"] <= last["recall_at_10"] <= 1.0
    assert set(last["parity_sweep_pt"]) == {
        f"{d}-s{s}" for d in ("isotropic", "gmm", "correlated")
        for s in (0, 1)}


def test_main_prints_every_lane_and_the_result(capsys):
    res = bench.main("cpu", n_db=8192, batch=256, iters=2, n_rec=256,
                     n_sweep=4096, n_stage=8192)
    lanes, last = _lines(capsys.readouterr().out)
    _check_result(lanes, last)
    assert last == json.loads(json.dumps(res))
    assert (last["n_db"], last["batch"]) == (8192, 256)
    assert last["ms_per_batch"] > 0 and last["codes_per_sec"] > 0


def test_cli_bench_runs_in_process(capsys, monkeypatch):
    """The four environment variables size the run; the sweep takes no
    more rows than the database has."""
    from cvt_tpu_torch.cli import main
    for name, value in (("BENCH_N", "4096"), ("BENCH_BATCH", "128"),
                        ("BENCH_ITERS", "1"), ("BENCH_NREC", "128")):
        monkeypatch.setenv(name, value)
    main(["bench", "--device", "cpu"])
    lanes, last = _lines(capsys.readouterr().out)
    _check_result(lanes, last)
    assert (last["n_db"], last["batch"]) == (4096, 128)
    assert lanes[3] == dict(lanes[3], n_rec=128)


def test_adc_bound_at_the_flat_path():
    """adc_segmin at 1M x 8,192 (Npad 1,015,808, tile 2,048): 2 Npad D
    Bpad int8 operations over 1,979 TOP/s, 1.076 ms (PERF.md)."""
    meta = dict(device="meta")
    args = (torch.empty((8192, 128), dtype=torch.int8, **meta),
            torch.empty((), dtype=torch.float32, **meta),
            torch.empty((1_015_808, 8), dtype=torch.uint8, **meta),
            torch.empty((8, 256, 16), dtype=torch.int8, **meta),
            torch.empty((128,), dtype=torch.float32, **meta),
            1_000_000, 2048)
    b = adc_bound(args, cached=False)
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 3) == 1.076
    assert b["ops"] == 2.0 * 1_015_808 * 128 * 8192
