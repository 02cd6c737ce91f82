"""cvt_tpu_torch.parallel held against cvt_tpu.parallel.

The port runs one process per device: four gloo ranks, spawned once for
the whole file (torch.multiprocessing.spawn, a FileStore under tmp_path),
drive every scenario; the reference runs on the first 4 of the virtual
CPU devices that tests/conftest.py provides, Pallas in interpret mode.
The PQ/OPQ codebooks are trained by cvt_tpu and carried across; the PQ
codebooks of the kernel scenarios are snapped to a power-of-two grid
(see snap_codebooks).

Tolerance: ids bitwise equal on every rank (the kernel twin's integer
keys equal Pallas's, the merges are stable top-k in the same
concatenation order); distances rtol 1e-5 (float32 sums in another
order). sharded_kmeans_step: rtol 1e-5. The group has a 60 s timeout and
the spawn a join limit, so a hang fails these tests instead of the run.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import NamedSharding, PartitionSpec as P

import _torch_parallel_workers as W
from _torch_parallel_workers import snap_codebooks
from cvt_tpu.parallel import (MultiHostADCServer as JServer,
                              ShardedADCSearcher as JSearcher, cpu_mesh,
                              make_mesh, sharded_kmeans_step, serving_mesh)
from cvt_tpu.parallel.sharded_search import sharded_search_2d
from cvt_tpu.quant import OPQ, ProductQuantizer
from cvt_tpu_torch.convert import flat_adc_from_numpy
from cvt_tpu_torch.parallel import QueryBatcher
from cvt_tpu_torch.parallel import make_mesh as t_make_mesh

WORLD = 4
JOIN_TIMEOUT_S = 240

pytestmark = pytest.mark.skipif(
    len(jax.devices("cpu")) < 4, reason="needs >=4 virtual CPU devices")


def _jax_refs(z):
    """The reference's results on the same data (the names the ranks
    write)."""
    pq = ProductQuantizer(jnp.asarray(z["codebooks"]))
    opq = OPQ(jnp.asarray(z["rotation"]),
              ProductQuantizer(jnp.asarray(z["opq_codebooks"])))
    base, queries, sbase = z["base"], z["queries"], z["serve_base"]
    mesh4 = cpu_mesh({"db": 4})
    ref = {}
    s = JSearcher(pq, mesh4, chunk=512, impl="pallas", tile_n=256, seg=64)
    s.load(base)
    ref["kernel"] = s.search(queries[:16], 10)
    s = JSearcher(pq, mesh4, chunk=512, impl="xla")
    s.load(base[:3000])
    ref["scan"] = s.search(queries[:8], 10)
    smesh = serving_mesh(jax.devices("cpu")[:4])
    for merge in ("allgather", "ring"):
        srv = JServer(pq, smesh, merge=merge, tile_n=128)
        srv.load(sbase)
        ref[f"serve_{merge}"] = srv.serve(queries, 10)
    ref["pipe"] = srv.serve_pipelined(queries[:48].reshape(3, 16, -1), 5)
    ref["local"] = srv.serve(queries[:8], 5)
    x, c0 = z["km_x"], z["km_c0"]
    kmesh = cpu_mesh({"dp": 4})
    ref["km"] = sharded_kmeans_step(
        kmesh, jax.device_put(x, NamedSharding(kmesh, P("dp", None))),
        jax.device_put(c0, NamedSharding(kmesh, P())))
    s = JSearcher(opq, cpu_mesh({"db": 2}), chunk=512)
    s.load(base)
    ref["opq"] = s.search(queries[:8], 5)
    mesh2 = make_mesh({"dp": 2, "db": 2}, jax.devices("cpu")[:4])
    ref["s2d"] = sharded_search_2d(mesh2, jnp.asarray(queries[:8]),
                                   jnp.asarray(z["codes2d"]),
                                   jnp.asarray(z["dsq2d"]), pq.codebooks, 5,
                                   chunk=256)
    srv = JServer(pq, mesh2, dp_axis="dp", tile_n=128)
    srv.load(sbase)
    ref["dp"] = srv.serve(queries[:29], 10)
    srv = JServer(pq, mesh2, dp_axis="dp", merge="ring", tile_n=128)
    srv.load(sbase)
    ref["dp_pipe"] = srv.serve_pipelined(queries[:32].reshape(2, 16, -1), 10)
    return {k: (np.asarray(v[0]), np.asarray(v[1])) for k, v in ref.items()}


def _spawn(tmp_path, fixture):
    """All scenarios in one spawn of WORLD gloo ranks; raise on a rank's
    failure or when the ranks outlive the join limit."""
    out = tmp_path / "out"
    out.mkdir()
    ctx = mp.spawn(W.run, args=(WORLD, str(tmp_path), fixture, str(out)),
                   nprocs=WORLD, join=False)
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks still running after "
                               f"{JOIN_TIMEOUT_S} s")
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(7)
    base = (rng.normal(size=(4096, 64)) * 20).astype(np.float32)
    queries = (rng.normal(size=(64, 64)) * 20).astype(np.float32)
    pq = ProductQuantizer(jnp.asarray(snap_codebooks(np.asarray(
        ProductQuantizer.train(jax.random.key(0), base[:2048], m=8, k=64,
                               iters=6).codebooks))))
    opq = OPQ.train(jax.random.key(1), base[:2048], m=8, k=64, opq_iters=2,
                    kmeans_iters=4, final_kmeans_iters=6)
    codes2d = np.asarray(pq.encode(base[:2048]))
    cbn = np.asarray(pq.codeword_sqnorms())
    dsq2d = cbn[np.arange(8)[None, :], codes2d].sum(1).astype(np.float32)
    km_x = rng.normal(size=(1024, 16)).astype(np.float32)
    z = dict(base=base, queries=queries, serve_base=base[:1500],
             codebooks=np.asarray(pq.codebooks),
             rotation=np.asarray(opq.rotation),
             opq_codebooks=np.asarray(opq.pq.codebooks), codes2d=codes2d,
             dsq2d=dsq2d, km_x=km_x, km_c0=km_x[:8].copy())
    fixture = str(tmp / "fixture.npz")
    np.savez(fixture, **z)
    ranks = _spawn(tmp, fixture)
    return ranks, _jax_refs(z)


def _check(runs, name, ref_name=None, ranks=range(WORLD)):
    out, ref = runs
    jd, ji = ref[ref_name or name]
    for r in ranks:
        np.testing.assert_array_equal(out[r][f"{name}_i"], ji)
        np.testing.assert_allclose(out[r][f"{name}_d"], jd, rtol=1e-5)


def test_sharded_kernel_impl_matches_reference(runs):
    """db=4, tile 256, seg 64 (tests/test_parallel.py:44)."""
    _check(runs, "kernel")


def test_sharded_scan_impl_n_not_divisible(runs):
    _check(runs, "scan")
    ids = runs[0][0]["scan_i"]
    assert ids.max() < 3000 and (ids >= 0).all()


def test_sharded_opq_on_db_2(runs):
    """A (dp=2, db=2) mesh: each 'db' group of two ranks is one 2-shard
    searcher, as the reference's db=2 mesh."""
    _check(runs, "opq")


def test_sharded_search_2d(runs):
    out, ref = runs
    jd, ji = ref["s2d"]
    for r in range(WORLD):
        dp_r = r // 2                        # ranks [[0, 1], [2, 3]]
        rows = slice(dp_r * 4, (dp_r + 1) * 4)
        np.testing.assert_array_equal(out[r]["s2d_i"], ji[rows])
        np.testing.assert_allclose(out[r]["s2d_d"], jd[rows], rtol=1e-5)


@pytest.mark.parametrize("merge", ["allgather", "ring"])
def test_serve_matches_reference(runs, merge):
    """1,500 rows over 4 shards at tile 128: 384 rows a shard, so the
    segment falls to 32 (12 segments >= k = 10)."""
    _check(runs, f"serve_{merge}")
    ids = runs[0][0][f"serve_{merge}_i"]
    assert ids.max() < 1500 and (ids >= 0).all()


def test_serve_pipelined_equals_serve(runs):
    out, _ = runs
    _check(runs, "pipe")
    for r in range(WORLD):
        np.testing.assert_array_equal(out[r]["pipe_i"], out[r]["pipe_ref_i"])
        np.testing.assert_array_equal(out[r]["pipe_d"], out[r]["pipe_ref_d"])


def test_load_local_equals_load(runs):
    out, _ = runs
    _check(runs, "local")
    per = 384
    for r in range(WORLD):
        start, stop, p = out[r]["rows"]
        assert (start, p) == (r * per, per)
        assert stop == min((r + 1) * per, 1500)


def test_serve_with_dp_axis(runs):
    """dp=2 x db=2: each rank scans half the batch (29 rows padded to 30
    in the reference's way) and every rank gets the whole batch back."""
    _check(runs, "dp")
    _check(runs, "dp_pipe")


def test_sharded_kmeans_step(runs):
    out, ref = runs
    jc, jobj = ref["km"]
    for r in range(WORLD):
        np.testing.assert_allclose(out[r]["km_c"], jc, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out[r]["km_obj"][0], jobj, rtol=1e-5)


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError):
        t_make_mesh({"db": 1})


@pytest.fixture(scope="module")
def flat():
    rng = np.random.default_rng(2)
    cb = rng.normal(size=(8, 32, 8)).astype(np.float32)
    codes = rng.integers(0, 32, size=(3000, 8)).astype(np.uint8)
    cbn = (cb ** 2).sum(-1)
    dsq = cbn[np.arange(8)[None, :], codes].sum(1).astype(np.float32)
    idx = flat_adc_from_numpy(codes, dsq, cb, device="cpu", impl="kernel")
    q = rng.normal(size=(64, 64)).astype(np.float32)
    return idx, q


def test_query_batcher_results(flat):
    """Blocks of mixed sizes batch into zero-padded serving batches of 32
    rows; each future gets exactly its own rows of the batches served."""
    idx, q = flat
    calls = []

    def serve(blk, k):
        d, i = idx.search(blk, k)
        calls.append((blk.copy(), d.numpy(), i.numpy()))
        return d, i

    batcher = QueryBatcher(serve, batch_size=32, k=10, max_wait_ms=20)
    blocks = [(0, 4), (4, 5), (5, 37), (37, 64)]
    try:
        futs = [batcher.submit(q[a:b]) for a, b in blocks]
        got = [f.result(timeout=60) for f in futs]
    finally:
        batcher.close()
    # the rows each query was served with, in submission order (the pad
    # rows are zeros, no query is)
    want_d, want_i, p = np.zeros((64, 10)), np.zeros((64, 10), int), 0
    for blk, d, i in calls:
        assert blk.shape == (32, 64)
        for j in range(32):
            if p < 64 and np.array_equal(blk[j], q[p]):
                want_d[p], want_i[p], p = d[j], i[j], p + 1
    assert p == 64
    for (a, b), (d, i) in zip(blocks, got):
        assert isinstance(i, np.ndarray) and i.shape == (b - a, 10)
        np.testing.assert_array_equal(i, want_i[a:b])
        np.testing.assert_array_equal(d, want_d[a:b].astype(np.float32))


def test_query_batcher_propagates_errors():
    def bad_serve(q, k):
        raise RuntimeError("boom")

    batcher = QueryBatcher(bad_serve, batch_size=8, k=5, max_wait_ms=5)
    fut = batcher.submit(np.zeros((2, 16), np.float32))
    try:
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=30)
    finally:
        batcher.close()
