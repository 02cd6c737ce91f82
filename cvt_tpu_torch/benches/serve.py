"""The serving tax (`_bench_serve.py` on the port): MultiHostADCServer over
1M codes on a one-card group against the raw kernel, at B 8,192, k 10.

    python -m cvt_tpu_torch.benches.serve [--device cpu]

Set-up: 1M `synthetic_sift` (seed 0, 8,192 fresh queries), OPQ (M 8, K
256, 6 OPQ iterations) on the first 262,144 rows, a one-rank group
(`init_distributed`: NCCL on the card, gloo on the CPU) and its 'db' mesh
(`serving_mesh`), codes encoded and loaded (timed). Rows:

  kernel     FlatADCIndex.search over the same codes, back to back
             (median of 5 windows of CUDA events over STACK batches);
  step       the function `serve` runs per batch (rotate, the shard's
             `adc_segmin` scan, the merge), back to back the same way
             (the port has no compiled serve step of its own to time);
  serve_dev  serve() on queries already on the card (host clock through a
             synchronize, median of 5 calls);
  serve_host serve() on host queries (the same, with their staging);
  pipelined  serve_pipelined with the ring merge over 8 micro-batches.

Numbers: the serving tax (step over kernel time), serve's top-1
agreement with the direct search, recall@1 of serve and of the reference
f32 LUT-ADC engine (`bench.reference_ids`) on N_REC queries against exact
ground truth, and `adc_segmin` alone on the server's arguments beside its
bound, then against its plain twin on them (the run stops on a
difference). Nothing is written to disk (BENCH_SERVE.md is the TPU's).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from cvt_tpu_torch import bench
from cvt_tpu_torch.benches._common import (Run, emit, full_precision,
                                           host_ms, kernel_lane, parse_args,
                                           sync, timed_windows)
from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.io.datasets import synthetic_sift
from cvt_tpu_torch.ops.kernels import recorded_args
from cvt_tpu_torch.parallel.serving import (MultiHostADCServer,
                                            init_distributed, serving_mesh)
from cvt_tpu_torch.quant.opq import OPQ
from cvt_tpu_torch.utils.metrics import recall_at_k
from cvt_tpu_torch.utils.profile import adc_bound

N, B, K = 1_000_000, 8192, 10
N_TRAIN, ENC_CHUNK, N_REC = 262_144, 131_072, 2048
STACK, MICRO = 8, 8


def serving_rows(srv, srv_ring, idx, queries: np.ndarray,
                 stack_n: int) -> dict:
    """The five timed rows and the serving tax."""
    dev = srv.device
    q_dev = torch.from_numpy(queries).to(dev)
    stack = torch.stack([q_dev] * stack_n)
    rows = {"kernel": timed_windows(lambda qb: idx.search(qb, K), stack),
            "step": timed_windows(lambda qb: srv.serve(qb, K), stack),
            "serve_dev": host_ms(lambda: srv.serve(q_dev, K), dev),
            "serve_host": host_ms(lambda: srv.serve(queries, K), dev)}
    qmb = queries.reshape(MICRO, len(queries) // MICRO, -1)
    rows["pipelined"] = host_ms(lambda: srv_ring.serve_pipelined(qmb, K),
                                dev)
    for r in rows.values():
        r["qps"] = len(queries) / r["ms"] * 1e3
    rows["serving_tax"] = rows["step"]["ms"] / rows["kernel"]["ms"]
    return rows


def agreement(srv, idx, queries, gt1: np.ndarray) -> dict:
    """Top-1 agreement of serve with the direct search, and recall@1 of
    serve and of the reference engine on the len(gt1) first queries."""
    _, i_srv = srv.serve(queries, K)
    _, i_dir = idx.search(queries, K)
    n = len(gt1)
    r1 = recall_at_k(i_srv[:n].cpu(), gt1, k=1)
    r1_ref = recall_at_k(bench.reference_ids(idx, queries[:n]).cpu(), gt1,
                         k=1)
    ids = i_srv.cpu()
    return {"top1_agreement": float((i_srv[:, 0] == i_dir[:, 0])
                                    .float().mean()),
            "recall_at_1_serve": r1, "recall_at_1_ref_f32_adc": r1_ref,
            "parity_pt": 100 * (r1_ref - r1),
            "ids_in_range": bool(((ids >= 0) & (ids < srv._n)).all())}


def main(device=None, *, n: int = N, batch: int = B, n_train: int = N_TRAIN,
         n_rec: int = N_REC, stack_n: int = STACK) -> dict:
    """Run every row (the card unless asked for the CPU). Starts a one-rank
    process group unless one is up, and ends the one it started."""
    run = Run("serve", device)
    dev = run.dev
    started = not dist.is_initialized()
    with full_precision():
        base, queries = synthetic_sift(n, 128, n_queries=batch, seed=0)
        opq = OPQ.train(torch.Generator().manual_seed(0), base[:n_train],
                        m=8, k=256, opq_iters=6, device=dev)
        init_distributed(device=dev)
        try:
            srv = MultiHostADCServer(opq, serving_mesh(dev.type))
            res = serve_run(run, srv, opq, base, queries, n_rec, stack_n)
        finally:
            if started:
                dist.destroy_process_group()
    return run.result(n=n, batch=batch, k=K, **res)


def serve_run(run, srv, opq, base, queries, n_rec: int, stack_n: int):
    """Encode and load, then every row, the agreement and the kernel."""
    dev = run.dev
    t = time.perf_counter()
    codes = np.concatenate([srv.encode(base[s:s + ENC_CHUNK])
                            for s in range(0, len(base), ENC_CHUNK)])
    srv.load(codes=codes)
    sync(dev)
    emit("setup", {"encode_load_s": time.perf_counter() - t,
                   "n": len(codes)})
    idx = FlatADCIndex(opq, impl="kernel")
    idx.add(codes=codes)
    idx._materialize()
    srv_ring = MultiHostADCServer(opq, srv.mesh, merge="ring")
    srv_ring.load(codes=codes)
    rows = serving_rows(srv, srv_ring, idx, queries, stack_n)
    for name in ("kernel", "step", "serve_dev", "serve_host", "pipelined"):
        emit(name, rows[name])
    gt1 = bench.ground_truth(base, queries, min(n_rec, len(queries)), dev)
    agree = emit("agreement", agreement(srv, idx, queries, gt1))
    q_dev = torch.from_numpy(queries).to(dev)
    args = recorded_args("adc_segmin", lambda: srv.serve(q_dev, K))
    kern = emit("adc_segmin", kernel_lane("adc_segmin", args,
                                          adc_bound(args, cached=False), dev,
                                          stack_n))
    return {"rows": rows, **agree,
            "kernels": {"adc_segmin": {
                "ms": kern["kernel_ms"], **{k: kern[k] for k in (
                    "bound_ms", "bound_by", "bound_share", "twin")},
                "npad": args[2].shape[0], "bpad": args[0].shape[0],
                "tile_n": args[6], "seg": args[7]}}}


if __name__ == "__main__":
    _, device = parse_args()
    main(device)
