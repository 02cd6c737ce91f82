"""Rank bodies for tests/test_torch_parallel.py (not collected: no test_
prefix). The spawned ranks import this module, which imports neither jax
nor cvt_tpu, so each child starts with torch alone.

snap_codebooks() is shared with the tests that run the kernel twin.
run() joins a gloo group through a FileStore, drives every scenario of
the parallel port on the fixture's data and writes its results to
rank<r>.npz; the parent compares them with cvt_tpu.parallel."""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

GROUP_TIMEOUT_S = 60


def snap_codebooks(cb):
    """Round each codebook dimension to a power-of-two grid on which its
    largest magnitude is exactly 127 steps. srow is then a power of two
    and every term of the in-kernel norm an integer times srow^2 below
    2^24, so the float32 norm is exact in any summation order and
    round(norm/qs) cannot depend on it (the twin sums in another order
    than Pallas's CPU dot, which moves rows whose norm/qs lies near a
    half-integer)."""
    amax = np.abs(cb).max(axis=1, keepdims=True)                 # [M,1,ds]
    step = 2.0 ** np.ceil(np.log2(amax / 127.0))
    q = np.clip(np.round(cb / step), -127, 127)
    top = np.abs(cb).argmax(axis=1)                              # [M, ds]
    m, ds = np.indices(top.shape)
    q[m, top, ds] = np.sign(cb[m, top, ds]) * 127
    return (q * step).astype(np.float32)


def _scenarios(z, rank: int) -> dict:
    from cvt_tpu_torch.convert import opq_from_numpy, pq_from_numpy
    from cvt_tpu_torch.parallel import (MultiHostADCServer, ShardedADCSearcher,
                                        cpu_mesh, init_distributed,
                                        sharded_kmeans_step)
    from cvt_tpu_torch.parallel.sharded_search import sharded_search_2d

    out = {}
    assert init_distributed() == rank        # a second start is a no-op
    pq = pq_from_numpy(z["codebooks"], device="cpu")
    opq = opq_from_numpy(z["rotation"], z["opq_codebooks"], device="cpu")
    base, queries = z["base"], z["queries"]
    q16 = queries[:16]

    mesh = cpu_mesh({"db": 4})
    s = ShardedADCSearcher(pq, mesh, chunk=512, impl="kernel", tile_n=256,
                           seg=64)
    s.load(base)
    out["kernel_d"], out["kernel_i"] = s.search(q16, 10)
    s = ShardedADCSearcher(pq, mesh, chunk=512, impl="scan")
    s.load(base[:3000])
    out["scan_d"], out["scan_i"] = s.search(queries[:8], 10)

    sbase = z["serve_base"]
    n = sbase.shape[0]
    for merge in ("allgather", "ring"):
        srv = MultiHostADCServer(pq, mesh, merge=merge, tile_n=128)
        srv.load(sbase)
        out[f"serve_{merge}_d"], out[f"serve_{merge}_i"] = srv.serve(
            queries, 10)
    # srv is the ring server: pipelined against serve, micro-batch by
    # micro-batch
    out["pipe_d"], out["pipe_i"] = srv.serve_pipelined(
        queries[:48].reshape(3, 16, -1), 5)
    parts = [srv.serve(queries[16 * t:16 * (t + 1)], 5) for t in range(3)]
    out["pipe_ref_d"] = torch.cat([p[0] for p in parts])
    out["pipe_ref_i"] = torch.cat([p[1] for p in parts])
    local = MultiHostADCServer(pq, mesh, tile_n=128)
    codes = local.encode(sbase)
    start, stop, per = local.shard_rows(n)
    out["rows"] = np.array([start, stop, per])
    local.load_local(codes[start:stop], n_global=n)
    out["local_d"], out["local_i"] = local.serve(queries[:8], 5)

    x = z["km_x"]
    per_x = x.shape[0] // 4
    c, obj = sharded_kmeans_step(cpu_mesh({"dp": 4}),
                                 x[rank * per_x:(rank + 1) * per_x],
                                 z["km_c0"])
    assert c.device == torch.device("cpu")    # numpy: the gloo mesh's CPU
    out["km_c"], out["km_obj"] = c, obj[None]

    mesh2 = cpu_mesh({"dp": 2, "db": 2})
    dp_r, db_r = mesh2.get_local_rank("dp"), mesh2.get_local_rank("db")
    s = ShardedADCSearcher(opq, mesh2, chunk=512)
    s.load(base)
    out["opq_d"], out["opq_i"] = s.search(queries[:8], 5)
    nl = z["codes2d"].shape[0] // 2
    bl = 8 // 2
    out["s2d_d"], out["s2d_i"] = sharded_search_2d(
        mesh2, torch.from_numpy(queries[dp_r * bl:(dp_r + 1) * bl]),
        torch.from_numpy(z["codes2d"][db_r * nl:(db_r + 1) * nl]),
        torch.from_numpy(z["dsq2d"][db_r * nl:(db_r + 1) * nl]),
        pq.codebooks, 5, chunk=256)
    srv = MultiHostADCServer(pq, mesh2, dp_axis="dp", tile_n=128)
    srv.load(sbase)
    out["dp_d"], out["dp_i"] = srv.serve(queries[:29], 10)
    srv = MultiHostADCServer(pq, mesh2, dp_axis="dp", merge="ring",
                             tile_n=128)
    srv.load(sbase)
    out["dp_pipe_d"], out["dp_pipe_i"] = srv.serve_pipelined(
        queries[:32].reshape(2, 16, -1), 10)
    return out


def run(rank: int, world: int, store_dir: str, fixture: str,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "store"), world)
    dist.init_process_group(
        "gloo", store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        z = dict(np.load(fixture))
        out = _scenarios(z, rank)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: np.asarray(v) for k, v in out.items()})
    finally:
        dist.destroy_process_group()
