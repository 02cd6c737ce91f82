"""The multi-device dry run: one sharded training + serving step over every
rank of the process group (counterpart of `__graft_entry__.py`'s
`dryrun_multichip` and `_dryrun_config5`).

Every rank of the default group calls `dryrun_multichip()` (a 1-rank
group on one card, or N gloo ranks on the CPU); each step asserts what
the JAX dry run asserts, and the function returns its figures. Rank r is
device r of the JAX mesh: the 'db' groups of a ('dp', 'db') mesh hold
consecutive ranks, as `parallel.mesh` lays them out.

  1. factor the ranks into a 2-D (dp, db) mesh (dp = the largest divisor
     <= sqrt(n));
  2. one data-parallel Lloyd step over 'dp' (`sharded_kmeans_step`);
  3. the PQ encode of this rank's training shard;
  4. a 2-D sharded ADC search: queries split over 'dp', codes over 'db',
     candidates merged over 'db' (`sharded_search_2d`);
  5. BASELINE config 5 (`_dryrun_config5`): MultiHostADCServer over all
     ranks with the ring merge against a 1-shard server (distances
     bitwise, ids where the distance is unique in its row) and against
     the reference engine (top-1 >= 0.8), serve_pipelined, the
     QueryBatcher, and, for an even rank count, the 2-D (dp 2) server
     with a batch not divisible by dp.

The data are `cvt_tpu`'s numpy draws, so the Lloyd objective of a dp 2
mesh is `MULTICHIP_r05.json`'s 184.326; the PQ of step 5 is trained by
the port (`torch.Generator`), so its ids are the port's own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.parallel.distributed_kmeans import sharded_kmeans_step
from cvt_tpu_torch.parallel.mesh import axis_size, make_mesh, mesh_device
from cvt_tpu_torch.parallel.serving import (MultiHostADCServer, QueryBatcher,
                                            serving_mesh)
from cvt_tpu_torch.parallel.sharded_search import sharded_search_2d
from cvt_tpu_torch.quant.pq import ProductQuantizer

# the JAX run's QueryBatcher flushes after 10 ms; here each rank's batcher
# must flush the same batches in the same order (the server's collectives
# run in lockstep), so it flushes only full batches
BATCHER_WAIT_MS = 60_000.0


def _toy_pq(m=8, k=32, ds=16, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, k, ds)).astype(np.float32)


def _factor(n: int) -> tuple[int, int]:
    """(dp, db): dp the largest divisor of n <= sqrt(n)."""
    dp = 1
    for cand in range(1, int(n ** 0.5) + 1):
        if n % cand == 0:
            dp = cand
    return dp, n // dp


def dryrun_multichip(n_devices: int | None = None, *,
                     verbose: bool = True) -> dict:
    """One sharded training + serving step over every rank of the default
    group (started by `init_distributed`; n_devices, if given, must equal
    its size). Every rank must call it. Raises AssertionError where the
    JAX dry run would; returns the figures, the same on every rank."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"{n_devices} devices asked, the group has {world}")
    n_devices = world
    dp, db = _factor(n_devices)
    mesh = make_mesh({"dp": dp, "db": db})
    dev = mesh_device(mesh)
    dp_r, db_r = mesh.get_local_rank("dp"), mesh.get_local_rank("db")

    rng = np.random.default_rng(0)
    m, k_sub, ds, kc = 8, 16, 16, 8
    d = m * ds
    b = 8 * dp                      # query batch, split over dp
    n = 64 * db                     # tiny code database, split over db
    n_train = 32 * dp               # k-means training rows, split over dp

    codebooks = _toy_pq(m, k_sub, ds)
    x_train = rng.normal(size=(n_train, d)).astype(np.float32)
    codes = rng.integers(0, k_sub, size=(n, m)).astype(np.uint8)
    cbn = (codebooks ** 2).sum(-1)
    dec_sq = cbn[np.arange(m)[None, :], codes].sum(1).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # this rank's pieces: its 'dp' slice of the training rows and the
    # queries, its 'db' shard of the codes
    n_loc, t_loc, b_loc = n // db, n_train // dp, b // dp
    xs = put(x_train[dp_r * t_loc:(dp_r + 1) * t_loc])
    # 1) one data-parallel Lloyd step (all_reduce over dp)
    new_c, obj = sharded_kmeans_step(mesh, xs, put(x_train[:kc]), axis="dp")
    # 2) encode this rank's training shard with the PQ codebooks
    enc = ProductQuantizer(put(codebooks)).encode(xs)
    # 3) 2-D sharded ADC search, merged over db
    dd, ii = sharded_search_2d(
        mesh, put(q[dp_r * b_loc:(dp_r + 1) * b_loc]),
        put(codes[db_r * n_loc:(db_r + 1) * n_loc]),
        put(dec_sq[db_r * n_loc:(db_r + 1) * n_loc]), put(codebooks), 5,
        chunk=n_loc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    assert new_c.shape == (kc, d)
    assert enc.shape == (t_loc, m) and enc.dtype == torch.uint8
    assert dd.shape == (b_loc, 5) and ii.shape == (b_loc, 5)
    assert bool(torch.isfinite(dd).all())
    assert int(ii.min()) >= 0 and int(ii.max()) < n
    out = {"dp": dp, "db": db, "objective": float(obj)}
    if verbose and dist.get_rank() == 0:
        print(f"dryrun_multichip ok: mesh dp={dp} x db={db}, "
              f"objective={out['objective']:.3f}")
    out.update(_dryrun_config5(n_devices, verbose=verbose))
    return out


def _dryrun_config5(n_devices: int, *, verbose: bool = True) -> dict:
    """BASELINE config 5 dry run: the multi-host serving path
    (MultiHostADCServer) over the n_devices ranks — per-shard `adc_segmin`
    scan (its twin on a CPU mesh), ring + all_gather top-k merges,
    pipelined serving, and the continuous query batcher.

    Parity is EXACT: the n-shard serve and a 1-shard serve run the same
    int8 packed scoring over the same tile boundaries, so per-shard top-k
    + merge must return bitwise-equal distances (ids may swap only
    between equal-distance candidates)."""
    dev = mesh_device(serving_mesh())
    rng = np.random.default_rng(1)
    per_shard = 2048                     # 4 x tile_n=512 tiles
    base = rng.normal(
        size=(per_shard * n_devices, 32)).astype(np.float32) * 10
    queries = rng.normal(size=(16, 32)).astype(np.float32) * 10
    gen = torch.Generator().manual_seed(0)
    pq = ProductQuantizer.train(gen, torch.from_numpy(base[:4096]).to(dev),
                                m=4, k=16, iters=4)

    ref = FlatADCIndex(pq, chunk=2048, impl="scan")
    ref.add(codes=pq.encode(torch.from_numpy(base).to(dev)))
    i_ref = ref.search(queries, 5)[1].cpu().numpy()

    # the 1-shard reference: a 'db' axis of 1, every rank a whole copy
    mesh1 = make_mesh({"rep": n_devices, "db": 1})
    srv1 = MultiHostADCServer(pq, mesh1, tile_n=512, seg=64)
    srv1.load(base)
    d1, i1 = (t.cpu().numpy() for t in srv1.serve(queries, 5))

    srv = MultiHostADCServer(pq, serving_mesh(), merge="ring", tile_n=512,
                             seg=64)
    srv.load(base)
    d, i = (t.cpu().numpy() for t in srv.serve(queries, 5))
    assert np.array_equal(d, d1), "sharded dists != single-shard dists"
    uniq = np.array([[np.sum(dr == dv) == 1 for dv in dr] for dr in d1])
    assert (i[uniq] == i1[uniq]).all(), "sharded ids != single-shard ids"
    agree = float((i[:, 0] == i_ref[:, 0]).mean())
    assert agree >= 0.8, f"config-5 serve-vs-reference-engine top-1 {agree}"

    _, i2 = srv.serve_pipelined(queries.reshape(2, 8, -1), 5)
    # the int8 query scale is per micro-batch, so near-tied candidates may
    # reorder against the one-batch serve: agreement, not identity
    agree_p = float((i2.cpu().numpy().reshape(16, 5)[:, 0]
                     == i[:, 0]).mean())
    assert agree_p >= 0.8, f"pipelined vs serve agreement {agree_p}"

    batcher = QueryBatcher(srv.serve, batch_size=8, k=5,
                           max_wait_ms=BATCHER_WAIT_MS)
    try:
        futs = [batcher.submit(queries[j:j + 4]) for j in range(0, 16, 4)]
        for f in futs:
            dd, _ = f.result(timeout=120)
            assert dd.shape == (4, 5)
    finally:
        batcher.close()

    # 2-D ('dp', 'db') serving: query batches split over dp instead of
    # replicated; parity with the reference engine
    dp2 = 2 if n_devices % 2 == 0 else 1
    out = {"agree": agree, "agree_pipelined": agree_p, "dp2": dp2}
    if dp2 > 1:
        mesh2 = make_mesh({"dp": dp2, "db": n_devices // dp2})
        assert axis_size(mesh2, "db") == n_devices // dp2
        srv2 = MultiHostADCServer(pq, mesh2, dp_axis="dp", merge="ring",
                                  tile_n=512, seg=64)
        srv2.load(base)
        i2d = srv2.serve(queries, 5)[1].cpu().numpy()
        agree2 = float((i2d[:, 0] == i_ref[:, 0]).mean())
        assert agree2 >= 0.8, f"config-5 2D serve parity {agree2}"
        # a batch size not divisible by dp is padded transparently
        d_odd, i_odd = srv2.serve(queries[:9], 5)
        assert tuple(d_odd.shape) == (9, 5)
        assert (i_odd.cpu().numpy()[:, 0] == i2d[:9, 0]).all()
        _, ip2d = srv2.serve_pipelined(queries.reshape(2, 8, -1), 5)
        agree_p2 = float((ip2d.cpu().numpy().reshape(16, 5)[:, 0]
                          == i2d[:, 0]).mean())
        assert agree_p2 >= 0.8, f"2D pipelined agreement {agree_p2}"
        out.update(agree_2d=agree2, agree_pipelined_2d=agree_p2)
    if verbose and dist.get_rank() == 0:
        print(f"dryrun config-5 ok: {n_devices}-shard serving, top-1 parity "
              f"{agree:.2f}, ring+pipelined+batcher exercised, 2D dp={dp2} "
              f"query-sharded serving verified")
    return out
