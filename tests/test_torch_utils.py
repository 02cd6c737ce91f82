"""The port's small framework-free pieces against cvt_tpu's, on the CPU:
`utils.metrics.auc` (1e-12 on tied scores), `config.Config` (JSON read by
the other package, both ways), `utils.timer.Timer`, `utils.profile`
(`roofline`, `chained_time`, `trace`, `measure_launch_overhead` asked for
the CPU) and `utils.__all__`; then the package as a whole: every module
imports with jax and cvt_tpu blocked, and every cvt_tpu module and
`__all__` entry has its counterpart."""

import importlib
import json
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import cvt_tpu
import cvt_tpu.utils as JU
import cvt_tpu_torch
import cvt_tpu_torch.utils as TU
from cvt_tpu import config as JC
from cvt_tpu_torch import config as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_auc_matches_reference_on_ties(seed):
    rng = np.random.default_rng(seed)
    labels = rng.random(500) < 0.3
    scores = np.round(rng.normal(size=500) + labels, 1)   # many ties
    want = JU.auc(labels, scores)
    assert abs(TU.auc(labels, scores) - want) <= 1e-12
    assert abs(TU.auc(torch.from_numpy(labels),
                      torch.from_numpy(scores)) - want) <= 1e-12
    assert np.isnan(TU.auc(np.ones(4, bool), np.arange(4.0)))  # one class
    assert TU.auc([0, 0, 1, 1], [0.1, 0.4, 0.35, 0.8]) == 0.75


def _custom(mod):
    return mod.Config(sift=mod.SiftConfig(max_features=1024, rootsift=False),
                      pq=mod.PQConfig(m=16, opq=False),
                      ivf=mod.IVFConfig(coarse_k=8192, bucket_cap=64),
                      retrieval=mod.RetrievalConfig(rerank=None),
                      mesh=mod.MeshConfig(dp=2, db=4), seed=7)


def test_config_json_both_ways(tmp_path):
    for src, dst in ((TC, JC), (JC, TC)):
        cfg = _custom(src)
        path = str(tmp_path / f"{src.__name__}.json")
        cfg.save(path)
        back = dst.Config.load(path)
        assert json.loads(back.to_json()) == json.loads(cfg.to_json())
        assert back.ivf.bucket_cap == 64 and back.retrieval.rerank is None
        assert isinstance(back.sift, dst.SiftConfig)
    assert TC.Config().to_json() == JC.Config().to_json()
    partial = TC.Config.from_json('{"pq": {"m": 4}, "seed": 3}')
    assert partial.pq.m == 4 and partial.pq.k == 256 and partial.seed == 3


def test_timer_observes_and_measures(capsys):
    with TU.Timer("span", verbose=True) as t:
        out = t.observe({"a": (torch.ones(3) * 2, [torch.zeros(2)])})
    assert out["a"][0].sum() == 6 and t.elapsed > 0
    assert "[timer] span:" in capsys.readouterr().out
    with TU.Timer(sync=False) as t2:
        pass
    assert t2.elapsed >= 0


def test_roofline_and_chained_time():
    r = TU.roofline(2e12, 3e9, 0.5)
    assert (r.tflops, r.hbm_gbps) == (4.0, 6.0)
    assert str(r) == "4.0 TFLOP/s, 6 GB/s"
    calls = []

    def fn(x, w):
        calls.append(x.shape)
        return x @ w
    stack = torch.randn(5, 16, 16)
    s = TU.chained_time(fn, stack, consts=(torch.eye(16),))
    assert s > 0 and calls == [(16, 16)] * 10             # warm-up + run
    calls.clear()
    TU.chained_time(fn, stack.numpy(), consts=(torch.eye(16),), warmup=False)
    assert len(calls) == 5
    assert TU.measure_launch_overhead(device="cpu") > 0


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with TU.trace(str(tmp_path)) as prof:
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path)
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    assert any("matmul" in e.key or "mm" in e.key
               for e in prof.key_averages())


def test_utils_all_covers_reference():
    assert set(JU.__all__) <= set(TU.__all__)
    assert "resolve_device" in TU.__all__
    for name in TU.__all__:
        assert hasattr(TU, name), name


def _modules(pkg) -> list[str]:
    """Relative names of a package's Python modules (not its built
    libraries)."""
    return sorted(m.name[len(pkg.__name__) + 1:] for m in
                  pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
                  if ".lib" not in m.name)


def test_every_reference_module_has_a_counterpart():
    """Same relative paths and public names; `ops.pallas` (TPU kernels)
    maps to `ops.kernels` (CUDA kernels and their twins)."""
    port = set(_modules(cvt_tpu_torch))
    for rel in _modules(cvt_tpu):
        there = rel.replace("ops.pallas", "ops.kernels")
        assert there in port, rel
        if rel.startswith("ops.pallas"):
            continue                    # the kernels' wrappers differ
        ref = importlib.import_module(f"cvt_tpu.{rel}")
        mine = importlib.import_module(f"cvt_tpu_torch.{there}")
        names = getattr(ref, "__all__", None)
        if names is None:
            names = [n for n, v in vars(ref).items()
                     if not n.startswith("_") and callable(v)
                     and getattr(v, "__module__", "") == ref.__name__]
        missing = [n for n in names if not hasattr(mine, n)]
        assert not missing, (rel, missing)


def test_package_imports_without_jax():
    """Every module of the port, in a fresh interpreter in which jax,
    jaxlib, optax and cvt_tpu cannot be imported."""
    names = ["cvt_tpu_torch"] + [f"cvt_tpu_torch.{m}"
                                 for m in _modules(cvt_tpu_torch)]
    for must in ("cvt_tpu_torch.train", "cvt_tpu_torch.index.hnsw",
                 "cvt_tpu_torch.parallel.dryrun", "cvt_tpu_torch.config",
                 "cvt_tpu_torch.utils.profile", "cvt_tpu_torch.bench",
                 *(f"cvt_tpu_torch.benches.{m}" for m in (
                     "ivf", "serve", "dogfood", "vocab5", "vocab",
                     "features", "hnsw")),
                 *(f"cvt_tpu_torch.probes.{m}" for m in (
                     "adc", "detect", "feat", "orient"))):
        assert must in names
    code = ("import sys, importlib\n"
            "for m in ('jax', 'jaxlib', 'optax', 'cvt_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {names!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'optax', 'cvt_tpu') and sys.modules[m]]\n"
            "assert not bad, bad\n"
            "print(len(" f"{names!r}" "))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) == len(names)
