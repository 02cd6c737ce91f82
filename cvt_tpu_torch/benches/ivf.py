"""IVF-ADC against the flat scan at N 1M and 10M (`_bench_ivf.py` on the
port).

    python -m cvt_tpu_torch.benches.ivf [--device cpu]

Switches: IVF_BENCH_B (batch, default 256), IVF_BENCH_SMALL=1 (N 200,000
in chunks of 65,536), IVF_BENCH_N (a comma list cutting N_LIST, e.g.
1000000).

At the reference operating point, coarseK 8192, m 16, K 256 (128-bit
codes, residual PQ; opq/src/IVFOPQ.cpp:56-63). For each N:

  1. data on the card, chunk by chunk: 65,536 gamma centres from numpy
     (seed 0), each CHUNK-row chunk drawn on the device from a
     torch.Generator seeded with its index (the 10M floats, 5.1 GB, are
     never staged from the host);
  2. IVFADCIndex.train and a flat ProductQuantizer (m 16), 10 + 10
     iterations on the first two chunks;
  3. every chunk through `encode_chunk` and the flat `pq.encode`; the
     exact top-10 of N_GT_Q queries by a running `merge_topk` across the
     chunks (`gt_step`); `build_from_codes` (host numpy, timed);
  4. lanes at batch B over STACK batches (each the median of 5 windows of
     CUDA events, fastest and slowest beside it): the flat kernel scan
     (`bench.fast_qps`: `adc_search`, then `adc_segmin` alone), the
     union-probe page scan `IVFADCIndex.search_fast` at nprobe 8 / 16 /
     64 with a page budget that holds the batch's union (`page_budget`;
     pages dropped in the timed batches are reported) and `ivf_page`
     alone on one of its batches, and one `search()` batch of the
     reference engine at nprobe 8 (host clock; it replaces the script's
     "old XLA probe" row), whose recall@10 at nprobe 16 is the parity
     reference for the page scan's. Each kernel's call on a lane's first
     batch is held against its plain twin (`ops.kernels.twin_check`:
     `ivf_page` bitwise, `adc_segmin` bitwise but near-half rows), and
     the run stops on a difference.

recall@10 is the script's: the share of queries whose exact top-1 is in
the returned ten. Where the script draws N // CHUNK whole chunks (917,504
rows for its "1M"), the suite draws N rows, the last chunk shorter; and
its page budget replaces the script's 2 pages per (query, probe), which
drops pages once cells outgrow a page (10M). One JSON line per (N,
engine), then the result line. Nothing is written to disk (BENCH_IVF.md
holds the TPU's figures).
"""

from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from cvt_tpu_torch import bench
from cvt_tpu_torch.benches._common import (Run, emit, full_precision,
                                           host_ms, kernel_lane, parse_args,
                                           sync, timed_windows)
from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.index.ivf_adc import IVFADCIndex
from cvt_tpu_torch.ops.kernels import recorded_args, twin_check
from cvt_tpu_torch.ops.topk import merge_topk, top_k_smallest
from cvt_tpu_torch.quant.pq import ProductQuantizer
from cvt_tpu_torch.utils.profile import ivf_bound, live_slots

K = 10
N_GT_Q = 1024
N_QUERIES = 8192
CHUNK = 131_072
N_LIST = (1_000_000, 10_000_000)
SMALL_N, SMALL_CHUNK = (200_000,), 65_536
N_CLUSTERS = 65_536
COARSE_K, M, KSUB, ITERS = 8192, 16, 256, 10
NPROBES, REF_NPROBE, SEARCH_NPROBE, PROBE_CHUNK = (8, 16, 64), 16, 8, 2
STACK = 32              # batches per timed window


def centers(n_clusters: int = N_CLUSTERS) -> np.ndarray:
    """The mixture's centres, numpy-seeded as the script's."""
    rng = np.random.default_rng(0)
    return rng.gamma(1.2, 24.0, size=(n_clusters, 128)).astype(np.float32)


def draw_chunk(cent: torch.Tensor, seed: int, m: int) -> torch.Tensor:
    """m rows on cent's device from a Generator seeded with `seed`: a
    uniformly drawn centre plus N(0, 12^2) noise, clipped to [0, 255]."""
    g = torch.Generator(device=cent.device).manual_seed(seed)
    ci = torch.randint(0, cent.shape[0], (m,), generator=g,
                       device=cent.device)
    noise = torch.randn((m, cent.shape[1]), generator=g, device=cent.device)
    return (cent[ci] + 12.0 * noise).clamp_(0.0, 255.0)


def gt_init(n_q: int, dev: torch.device):
    return (torch.full((n_q, K), float("inf"), device=dev),
            torch.full((n_q, K), -1, dtype=torch.int64, device=dev))


def gt_step(qg, xc, off: int, gt_d, gt_i):
    """Merge one chunk's exact top-K (squared L2) into the running top-K;
    ties go to the lower id."""
    d2 = (torch.sum(qg * qg, -1)[:, None] - 2.0 * (qg @ xc.T)
          + torch.sum(xc * xc, -1)[None, :])
    nd, nj = top_k_smallest(d2, K)
    return merge_topk(torch.cat([gt_d, nd], -1),
                      torch.cat([gt_i, nj.long() + off], -1), K)


def build(n: int, cent: torch.Tensor, queries: torch.Tensor, *,
          chunk: int, n_gt: int, coarse_k: int = COARSE_K,
          iters: int = ITERS) -> dict:
    """Steps 2-3 over n rows in chunks of `chunk` (the last one shorter)
    -> the IVF index, the flat index, the ground-truth ids [n_gt, K] and
    the stage times."""
    dev = cent.device
    t0 = time.perf_counter()
    sample = torch.cat([draw_chunk(cent, i, chunk) for i in range(2)])
    ivf = IVFADCIndex(coarse_k=coarse_k, m=M, k=KSUB, device=dev)
    ivf.train(torch.Generator().manual_seed(0), sample, coarse_iters=iters,
              pq_iters=iters)
    pq_flat = ProductQuantizer.train(torch.Generator().manual_seed(1),
                                     sample, M, KSUB, iters=iters)
    del sample
    sync(dev)
    t_train = time.perf_counter() - t0

    t0 = time.perf_counter()
    parts = ([], [], [], [])
    gt_d, gt_i = gt_init(n_gt, dev)
    qg = queries[:n_gt]
    for i in range(-(-n // chunk)):
        xc = draw_chunk(cent, i, min(chunk, n - i * chunk))
        for p, t in zip(parts, (*ivf.encode_chunk(xc), pq_flat.encode(xc))):
            p.append(t.cpu().numpy())
        gt_d, gt_i = gt_step(qg, xc, i * chunk, gt_d, gt_i)
    gt_ids = gt_i.cpu().numpy()
    t_encode = time.perf_counter() - t0

    t0 = time.perf_counter()
    ivf.build_from_codes(*(np.concatenate(p) for p in parts[:3]))
    sync(dev)
    t_build = time.perf_counter() - t0
    flat = FlatADCIndex(pq_flat, impl="kernel")
    flat.add(codes=np.concatenate(parts[3]))
    flat._materialize()
    return {"ivf": ivf, "flat": flat, "gt_ids": gt_ids,
            "train_s": t_train, "encode_s": t_encode, "build_s": t_build}


def recall10(ids, gt_ids: np.ndarray) -> float:
    """Share of queries whose exact top-1 is among their returned ids."""
    ids = (ids.cpu().numpy() if isinstance(ids, torch.Tensor)
           else np.asarray(ids))[:len(gt_ids)]
    return float(np.mean(np.any(ids == gt_ids[:, :1], axis=1)))


def ids_in_range(ids, n: int) -> bool:
    ids = torch.as_tensor(ids)
    return bool(torch.all(((ids >= 0) & (ids < n)) | (ids == -1)))


def query_stack(queries: torch.Tensor, batch: int, n: int) -> torch.Tensor:
    """[n, batch, D]: windows of the query pool at seeded offsets (seed 7),
    as the script draws them."""
    sr = np.random.default_rng(7)
    hi = max(len(queries) - batch, 1)
    return torch.stack([queries[int(sr.integers(0, hi)):][:batch]
                        for _ in range(n)])


def page_budget(ivf: IVFADCIndex, nprobe: int, batch: int) -> int:
    """A `search_fast` page budget that holds any batch of `batch` queries
    at nprobe: each (query, probe) pair owns at most the pages its cell
    spans. The script's budget, 2 pages a pair, assumes a cell within a
    page; at 10M a cell spans several, and that budget drops pages."""
    return batch * nprobe * max(2, ivf.cell_pages())


def flat_lane(flat: FlatADCIndex, stack, queries, gt_ids) -> dict:
    """The flat kernel scan at the stack's batch; its recall@10; the
    `adc_segmin` call of its first batch against the kernel's twin."""
    out = bench.fast_qps(flat, flat._rotate(stack))
    args = recorded_args("adc_segmin", lambda: flat.search(stack[0], K))
    ids = flat.search(queries[:len(gt_ids)], K)[1]
    return dict(out, r10=recall10(ids, gt_ids),
                ids_in_range=ids_in_range(ids, flat.ntotal),
                npad=args[2].shape[0], twin=twin_check("adc_segmin", args))


def ivf_lane(ivf: IVFADCIndex, nprobe: int, stack, queries,
             gt_ids) -> dict:
    """`search_fast` at nprobe over the stack with `page_budget`,
    `ivf_page` alone on its first batch's arguments, recall@10 and
    dropped pages of search_fast over the ground-truth queries."""
    dev = stack.device
    budget = page_budget(ivf, nprobe, stack.shape[1])

    def one(qb):
        return ivf.search_fast(qb, K, nprobe=nprobe, max_pages=budget)
    t = timed_windows(one, stack)
    dropped_timed = max(int(one(qb)[2]) for qb in stack)
    args = recorded_args("ivf_page", lambda: one(stack[0]))
    kern = kernel_lane("ivf_page", args, ivf_bound(args), dev,
                       stack.shape[0])
    qg = queries[:len(gt_ids)]
    _, ids, drop = ivf.search_fast(
        qg, K, nprobe=nprobe, max_pages=page_budget(ivf, nprobe, len(qg)))
    return dict(t, **kern, qps=stack.shape[1] / t["ms"] * 1e3,
                probed_pages=int(args[9]), live_slots=live_slots(args),
                slots=args[6].shape[0], dropped_timed=dropped_timed,
                r10=recall10(ids, gt_ids), dropped=int(drop),
                ids_in_range=ids_in_range(ids, ivf.ntotal))


def search_lane(ivf: IVFADCIndex, queries, gt_ids, batch: int) -> dict:
    """One batch of the reference engine at nprobe SEARCH_NPROBE (host
    clock, after a warm call), and its recall@10 at REF_NPROBE over the
    ground-truth queries."""
    dev = queries.device
    qb = queries[:batch]
    t = host_ms(lambda: ivf.search(qb, K, nprobe=SEARCH_NPROBE,
                                   probe_chunk=PROBE_CHUNK), dev)
    qg = queries[:len(gt_ids)]
    ids = torch.cat([ivf.search(qg[s:s + batch], K, nprobe=REF_NPROBE)[1]
                     for s in range(0, len(qg), batch)])
    return dict(t, nprobe=SEARCH_NPROBE, tail=ivf.tail_len,
                r10_ref_nprobe=REF_NPROBE, r10=recall10(ids, gt_ids),
                ids_in_range=ids_in_range(ids, ivf.ntotal))


def run_n(n: int, cent, queries, *, chunk: int, batch: int, n_gt: int,
          coarse_k: int, iters: int, stack_n: int, nprobes) -> dict:
    """Every lane at one N; one JSON line per engine."""
    t_round = time.perf_counter()
    b = build(n, cent, queries, chunk=chunk, n_gt=n_gt, coarse_k=coarse_k,
              iters=iters)
    ivf, flat, gt_ids = b["ivf"], b["flat"], b["gt_ids"]
    n_rows = ivf.ntotal
    emit("build", {"N": n, "engine": "build", "rows": n_rows,
                   "train_s": b["train_s"], "encode_gt_s": b["encode_s"],
                   "build_host_s": b["build_s"],
                   "pages": ivf._pg_dec8_t.shape[1] // ivf._pg_lp,
                   "tail": ivf.tail_len})
    stack = query_stack(queries, batch, stack_n)
    row = {"N": n, "rows": n_rows, "build_host_s": b["build_s"],
           "flat": emit("flat", {"N": n, "engine": "flat", **flat_lane(
               flat, stack, queries, gt_ids)})}
    for p in nprobes:
        row[f"ivf_nprobe{p}"] = emit(f"ivf_nprobe{p}", {
            "N": n, "engine": "ivf_union", "nprobe": p,
            **ivf_lane(ivf, min(p, coarse_k), stack, queries, gt_ids)})
    row["search"] = emit("search", {"N": n, "engine": "search", **search_lane(
        ivf, queries, gt_ids, batch)})
    row["round_s"] = time.perf_counter() - t_round
    return row


def _env_n_list() -> tuple[tuple, int]:
    """N_LIST and CHUNK after the script's switches."""
    n_list, chunk = N_LIST, CHUNK
    if os.environ.get("IVF_BENCH_SMALL"):
        n_list, chunk = SMALL_N, SMALL_CHUNK
    if os.environ.get("IVF_BENCH_N"):
        n_list = tuple(int(v) for v in os.environ["IVF_BENCH_N"].split(","))
    return n_list, chunk


def main(device=None, *, n_list=None, chunk: int | None = None,
         batch: int | None = None, n_gt: int = N_GT_Q,
         n_queries: int = N_QUERIES, n_clusters: int = N_CLUSTERS,
         coarse_k: int = COARSE_K, iters: int = ITERS,
         stack_n: int = STACK, nprobes=NPROBES) -> dict:
    """Run every N (the card unless asked for the CPU); sizes left None
    read the script's switches. Returns the result line."""
    run = Run("ivf", device)
    dev = run.dev
    env_n, env_chunk = _env_n_list()
    n_list = env_n if n_list is None else n_list
    chunk = env_chunk if chunk is None else chunk
    batch = int(os.environ.get("IVF_BENCH_B", 256)) if batch is None \
        else batch
    rows = []
    with full_precision():
        cent = torch.from_numpy(centers(n_clusters)).to(dev)
        queries = draw_chunk(cent, 999, n_queries)
        for n in n_list:
            rows.append(run_n(n, cent, queries, chunk=chunk, batch=batch,
                              n_gt=n_gt, coarse_k=coarse_k, iters=iters,
                              stack_n=stack_n, nprobes=nprobes))
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    kernels = {"adc_segmin": {}, "ivf_page": {}}
    for r in rows:
        f = r["flat"]
        kernels["adc_segmin"][str(r["N"])] = {
            "ms": f["adc_segmin_ms"], **{k: f[k] for k in (
                "bound_ms", "bound_by", "bound_share", "npad", "twin")}}
        kernels["ivf_page"][str(r["N"])] = {
            str(p): {k: r[f"ivf_nprobe{p}"][k] for k in (
                "kernel_ms", "bound_ms", "bound_by", "bound_share",
                "live_slots", "slots", "twin")} for p in nprobes}
    summary = [{"N": r["N"], "rows": r["rows"],
                "build_host_s": r["build_host_s"], "round_s": r["round_s"],
                "flat": {k: r["flat"][k] for k in (
                    "ms_per_batch", "value", "r10", "ids_in_range")},
                **{f"ivf_nprobe{p}": {k: r[f"ivf_nprobe{p}"][k] for k in (
                    "ms", "ms_spread", "qps", "r10", "dropped",
                    "dropped_timed", "ids_in_range")} for p in nprobes},
                "search": {k: r["search"][k] for k in (
                    "ms", "r10", "tail", "ids_in_range")}} for r in rows]
    return run.result(batch=batch, k=K, coarse_k=coarse_k, m=M, ksub=KSUB,
                      n_gt=n_gt, ref_nprobe=REF_NPROBE, rows=summary,
                      kernels=kernels)


if __name__ == "__main__":
    _, device = parse_args()
    main(device)
