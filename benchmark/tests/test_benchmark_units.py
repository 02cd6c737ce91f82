"""The yardstick's arithmetic on the CPU: roofline counts worked out by
hand, qps over the whole window, the trace readers, the seed's
determinism, and the check that keeps JAX out."""

import ast
import glob
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from conftest import ROOT
from benchmark import data, generator, harness
from benchmark.roofline import bound_seconds
from benchmark.trace import (Event, busy_seconds, idle_gaps, kernel_times,
                             op_seconds, short)

REG = harness.Registry(ROOT)
PEAK = {"int8_ops_per_s": 1.0e3, "bytes_per_s": 1.0e2}


def test_adc_segmin_counts_by_hand():
    # n 4, b 2, d 8, m 2, k 3: 2*4*8*2 ops; 4*2 + 4*4 + 2*8*4 + 2*3*8 bytes
    ops, nbytes = REG.roofline("adc_segmin").work(4, 2, 8, 2, 3)
    assert ops == 128 and nbytes == 8 + 16 + 64 + 48
    assert bound_seconds(ops, nbytes, PEAK) == pytest.approx(1.36)


def test_ivf_page_counts_by_hand():
    # 10 probed rows over the batch, a union of 6 rows, b 2, d 4, m 2, k 1
    ops, nbytes = REG.roofline("ivf_page").work(10, 6, 2, 4, 2, 1)
    assert ops == 80 and nbytes == 6 * 10 + 2 * 4 * 4 + 2 * 1 * 8
    assert bound_seconds(ops, nbytes, PEAK) == pytest.approx(1.08)


def test_selection_candidates_by_hand():
    from benchmark.reference import adc
    # rows 8..15 of an index of 16: segments of 2, tiles of 4, 1 per tile
    d = torch.tensor([[5.0, 3.0, 4.0, 6.0, 9.0, 1.0, 2.0, 0.5]])
    sel = {"segment_rows": 2, "tile_rows": 4, "per_tile": 1}
    cd, ci = adc.candidates(d, 8, sel, 16, 4)
    assert cd.tolist() == [[3.0, 0.5]] and ci.tolist() == [[9, 15]]
    # fewer tiles than k candidates: the segment rule alone
    cd, ci = adc.candidates(d, 8, sel, 16, 5)
    assert cd.tolist() == [[3.0, 4.0, 1.0, 0.5]]
    assert ci.tolist() == [[9, 10, 13, 15]]
    # the top 3 under the rule passes over row 14 (2.0), whose segment
    # holds row 15 (0.5), and row 10 (4.0), whose tile holds row 9 (3.0)
    bd, bi = adc.keep_best(torch.zeros((1, 0)), torch.zeros((1, 0),
                           dtype=torch.int64), d, torch.arange(8, 16), 2,
                           sel, 16)
    assert bd.tolist() == [[0.5, 3.0]] and bi.tolist() == [[15, 9]]


def test_rank_gap_reads_every_rank():
    from benchmark.reference import adc, compare
    g = torch.Generator().manual_seed(3)
    base = torch.randint(0, 256, (512, 8), generator=g).float()
    cb = torch.randn(2, 16, 4, generator=g, dtype=torch.float64) * 40 + 128
    ref = adc.FlatADC(base, torch.eye(8), cb)
    q = torch.randint(0, 256, (16, 8), generator=g).float()
    d, i = ref.best(q, 5)
    assert compare.numbers(ref, q, i, d)["rank_gap"] < 1e-12
    far = torch.cat([i[:, :1], (i[:, 1:] + 256) % 512], 1)
    got = compare.numbers(ref, q, far, ref.dists(q, far))
    assert got["top1_gap"] < 1e-12 and got["dist_err"] < 1e-12
    assert got["rank_gap"] > 0.05


def _ctx(**kw):
    base = dict(traffic={"loop": "closed"}, setup_s=3.0, slice=None,
                events=[], traced_calls=0, registry=REG, kind="cpu")
    base.update(kw)
    return SimpleNamespace(**base)


def test_qps_counts_every_query_over_the_whole_window():
    w = generator.Window(queries=3000, seconds=1.5)
    assert REG.reader("qps").read(_ctx(window=w)) == 2000.0


def _ev(name, dev, s, e):
    return Event(name, dev, s, e)


def test_trace_readers():
    ev = [_ev("bench.slice", False, 0.0, 10.0),
          _ev("aten::mm", False, 0.5, 3.5),
          _ev("void ns::adc_segmin_kernel<128, 3>(int*)", True, 1.0, 3.0),
          _ev("adc_segmin_cached_kernel<128>", True, 4.0, 5.0),
          _ev("Memcpy HtoD (Pageable -> Device)", True, 2.5, 4.5),
          _ev("cudaLaunchKernel", False, 6.0, 6.5)]
    assert busy_seconds(ev, 0.0, 10.0) == pytest.approx(4.0)
    assert kernel_times(ev, 0.0, 10.0, "adc_segmin_kernel") == [2.0]
    assert sum(op_seconds(ev, 0.0, 10.0).values()) == pytest.approx(5.0)
    gaps = idle_gaps(ev, 0.0, 10.0)
    assert gaps == pytest.approx({"aten::mm": 1.0, "bench.slice": 5.0})
    assert short("void (anonymous namespace)::tiletop_kernel(int const*)") \
        == "tiletop_kernel"


def test_device_readers_report_nothing_without_a_trace():
    w = generator.Window(queries=10, seconds=1.0)
    for m in REG.bench["per_layer"]:
        assert REG.reader(m["name"]).read(_ctx(window=w)) is None, m["name"]


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 12345])
def test_inputs_repeat_for_one_seed(seed):
    a = data.base_vectors(seed, 4096, 16, "cpu")
    assert torch.equal(a, data.base_vectors(seed, 4096, 16, "cpu"))
    assert not torch.equal(a, data.base_vectors(seed + 1, 4096, 16, "cpu"))
    assert float(a.min()) >= 0 and float(a.max()) <= 255
    assert torch.equal(a, a.round())
    q = data.query_pool(seed, 4096, 16, 64, "cpu")
    assert np.array_equal(q, data.query_pool(seed, 4096, 16, 64, "cpu"))
    flat = {"train_rows": 2048, "m": 4, "k": 16, "iters": 3}
    r1, c1 = data.flat_quantizer(seed, a, flat)
    r2, c2 = data.flat_quantizer(seed, a, flat)
    assert torch.equal(r1, r2) and torch.equal(c1, c2)
    assert torch.allclose(r1 @ r1.T, torch.eye(16), atol=1e-5)
    ivf = dict(flat, coarse_k=32, coarse_iters=3)
    k1, p1 = data.ivf_quantizer(seed, a, ivf)
    k2, p2 = data.ivf_quantizer(seed, a, ivf)
    assert torch.equal(k1, k2) and torch.equal(p1, p2)
    assert c1.is_contiguous() and p1.is_contiguous()


def test_means_equal_plain_cluster_means():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(500, 3, generator=g)
    a = torch.randint(0, 6, (500,), generator=g)
    a[a == 2] = 3                                  # cluster 2 stays empty
    old = torch.full((6, 3), 7.0)
    m = data._means(x, a, old)
    for j in range(6):
        want = old[j] if j == 2 else x[a == j].double().mean(0).float()
        assert torch.allclose(m[j], want, atol=1e-6)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.forbidden_modules(["cvt_tpu_torch.index"]) == []
    assert harness.forbidden_modules(["cvt_tpu.ops", "flax"]) == \
        ["cvt_tpu", "flax"]


def test_benchmark_loads_no_jax_in_a_fresh_process():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.harness as h, benchmark.reference.control\n"
            "import benchmark.calibrate\n"
            "r = h.Registry()\n"
            "[r.system(n) for n in ('flat', 'ivf')]\n"
            "r.kind('adc')\n"
            "[r.reader(m['name']) for m in r.bench['end_to_end'] "
            "+ r.bench['per_layer']]\n"
            "print(h.forbidden_modules())\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "reference",
                                       "*.py")):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "torch",
                                          "benchmark"), (path, name)
            assert not name.startswith("benchmark.") or \
                name.startswith("benchmark.reference"), (path, name)


def test_benchmark_reads_none_of_the_old_benches():
    banned = ("cvt_tpu_torch.bench", "cvt_tpu_torch.benches",
              "cvt_tpu_torch.probes", "bench", "chip_smoke")
    for path in glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                          recursive=True):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "cvt_tpu"), (path, name)
            assert not any(name == b or name.startswith(b + ".")
                           for b in banned), (path, name)
            assert not name.startswith(("_bench", "_prof")), (path, name)


def test_run_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from benchmark import run
    t = time.perf_counter()
    assert run.main(["--workload", "sift1m-opq8.b8192", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert time.perf_counter() - t < 30


def test_run_fails_in_a_checkout_of_the_benchmark_alone(tmp_path):
    import shutil
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "sift1m-opq8.b8192", "--seed", "1", "--seconds",
                          "1"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
