"""`python -m cvt_tpu_torch.cli serve` held against cvt_tpu's
MultiHostADCServer on a 1-device mesh, on a pack that cvt_tpu's
FlatADCIndex.save wrote; and every new port module importable with jax
and cvt_tpu blocked.

The command runs in a subprocess whose `jax` and `cvt_tpu` imports are
blocked (sys.modules entries set to None), as on a machine without JAX;
it starts a 1-rank gloo group through a FileStore. Tolerance: ids
bitwise. The PQ codebooks are snapped to a power-of-two grid so that
the in-kernel norm is exact in any summation order (see
tests/_torch_parallel_workers.py)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cvt_tpu.index import FlatADCIndex
from cvt_tpu.io.vecs import write_fvecs
from cvt_tpu.parallel import MultiHostADCServer, serving_mesh
from cvt_tpu.quant import ProductQuantizer
from _torch_parallel_workers import snap_codebooks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = "import sys; sys.modules['jax'] = None; sys.modules['cvt_tpu'] = None"
MODULES = ["cvt_tpu_torch.quant.sq", "cvt_tpu_torch.quant.pca",
           "cvt_tpu_torch.index.flat_sq", "cvt_tpu_torch.parallel",
           "cvt_tpu_torch.parallel.mesh", "cvt_tpu_torch.parallel.serving",
           "cvt_tpu_torch.parallel.sharded_search",
           "cvt_tpu_torch.parallel.distributed_kmeans",
           "cvt_tpu_torch.cli", "cvt_tpu_torch.convert"]


def _python(code: str, *args, stdin: str | None = None):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", code, *args], input=stdin,
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=120)


def _serve(*args, stdin=None):
    code = (BLOCK + "; import runpy; sys.argv = ['cli'] + sys.argv[1:]; "
            "runpy.run_module('cvt_tpu_torch.cli', run_name='__main__')")
    r = _python(code, "serve", *args, stdin=stdin)
    assert r.returncode == 0, r.stderr[-3000:]
    return np.array([json.loads(line)["ids"]
                     for line in r.stdout.splitlines() if line.strip()])


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(4)
    base = (rng.normal(size=(3000, 64)) * 20).astype(np.float32)
    q = (rng.normal(size=(40, 64)) * 20).astype(np.float32)
    pq = ProductQuantizer(jnp.asarray(snap_codebooks(np.asarray(
        ProductQuantizer.train(jax.random.key(0), base[:2048], m=8, k=64,
                               iters=4).codebooks))))
    idx = FlatADCIndex(pq)
    idx.add(base)
    idx.save(str(tmp / "pack.npz"))
    write_fvecs(str(tmp / "q.fvecs"), q)
    srv = MultiHostADCServer(pq, serving_mesh(jax.devices("cpu")[:1]))
    srv.load(codes=np.asarray(pq.encode(base)))
    return tmp, q, srv


def test_serve_batch_mode_matches_reference(pack):
    tmp, q, srv = pack
    ids = _serve("--index", str(tmp / "pack.npz"), "--queries",
                 str(tmp / "q.fvecs"), "--k", "10", "--batch", "16",
                 "--device", "cpu")
    want = np.concatenate([np.asarray(srv.serve(q[s:s + 16], 10)[1])
                           for s in range(0, 40, 16)])
    np.testing.assert_array_equal(ids, want)


def test_serve_stdin_mode_matches_reference(pack):
    """One query per line through the QueryBatcher: each is served in a
    batch of its own plus zero rows, which change no query's fold."""
    tmp, q, srv = pack
    lines = "\n".join(json.dumps(r.tolist()) for r in q[:3]) + "\n\n"
    ids = _serve("--index", str(tmp / "pack.npz"), "--stdin", "--k", "5",
                 "--batch", "8", "--merge", "ring", "--device", "cpu",
                 stdin=lines)
    want = np.concatenate([np.asarray(srv.serve(q[j:j + 1], 5)[1])
                           for j in range(3)])
    np.testing.assert_array_equal(ids, want)


def test_new_modules_import_without_jax():
    r = _python(BLOCK + "; import importlib\n"
                "for m in sys.argv[1:]: importlib.import_module(m)\n"
                "print('ok')", *MODULES)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "ok"
