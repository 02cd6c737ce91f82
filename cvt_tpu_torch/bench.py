"""North-star benchmark of the port: SIFT1M-scale flat ADC search QPS at
recall parity (BASELINE.json configs 1, 2 and 4), the counterpart of the
repository's top-level `bench.py`.

    python -m cvt_tpu_torch.bench                    # on the card
    python -m cvt_tpu_torch.cli bench [--device cpu]

Pipeline (each lane a function over the trained quantizer and the data;
`main` composes them and prints one JSON line per lane as soon as it
ends, then bench.py's object as the last line):

  1. data: SIFT1M where it is on disk, else `synthetic_sift` with fresh
     queries (seed 0);
  2. OPQ (M 8, K 256 -> 64-bit codes) trained on N_TRAIN vectors from a
     seeded `torch.Generator`;
  3. ingest (host floats -> codes) and encode (device floats -> codes);
  4. exact ground truth (FlatIndex, 512 queries at a time);
  5. recall@1 / @10 of the fast path, and of the independent f32 LUT-ADC
     engine `_adc_scan` over the same codes: their recall@1 difference in
     points is the parity BASELINE.md holds to 0.5 pt;
  6-8. steady-state QPS of the fast path (`adc_search`), the decoded
     cache (`adc_search_cached`) and the exact path (exact=True, with its
     recall);
  9. the int8 SQ lane at d 64 and 128 on L2-normalised data;
  10. the parity sweep: 3 distributions x 2 seeds, bench.py's own data;
  11. uint8 staged ingest.

Where it differs from bench.py: times come from CUDA events over ITERS
batches launched back to back (`utils.profile.chained_time`); each QPS is
the median of WINDOWS such windows with the slowest and fastest beside
it (`<key>_spread`), and so is the uint8 ingest rate over WINDOWS
passes; nothing is subtracted (`launch_overhead_ms` is reported as
measured). The TPU anchor `vs_baseline` is gone;
`int8_tops_effective` counts the kernel's int8 operations (2 Npad D Bpad
per batch) and `bound_ms` / `bound_share` put `adc_segmin` alone at the
lane-6 shape against the card's bound (`utils.profile.adc_bound`). The
last line also names the device (nvidia-smi's name and power limit, or
"cpu") and the launches of the three kernel wrappers over the run.
Host-clock lanes synchronise before they read the clock. PyTorch's TF32
flags stay as the caller set them: `_adc_scan`'s products are exact only
at full float32, PyTorch's default.

Recall here is not comparable with the TPU rounds' (BENCH_r0*.json): the
OPQ comes from a torch.Generator, not a jax.random key.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from cvt_tpu_torch.index import FlatADCIndex, FlatIndex, FlatSQIndex
from cvt_tpu_torch.index.flat_adc import _adc_scan
from cvt_tpu_torch.io.datasets import load_sift1m, synthetic_sift
from cvt_tpu_torch.ops.kernels import adc_scan as kernels
from cvt_tpu_torch.ops.kernels import launch_counts
from cvt_tpu_torch.ops.linalg import l2_normalize
from cvt_tpu_torch.quant import OPQ, ScalarQuantizer
from cvt_tpu_torch.utils.device import resolve_device
from cvt_tpu_torch.utils.metrics import recall_at_k
from cvt_tpu_torch.utils.profile import (adc_bound, card_line, chained_time,
                                         measure_launch_overhead)

N_DB = 1_000_000
N_TRAIN = 131_072
N_QUERIES = 8192
K = 10
BATCH = 8192
M, KSUB = 8, 256
ITERS = 32
N_REC = 2048
# the parity sweep: base rows, queries, OPQ training sample
N_SWEEP, NQ_SWEEP, N_SWEEP_TRAIN = 131_072, 2048, 65_536
# rows encoded from device memory (codes_per_sec) and staged as uint8
N_STAGE = 524_288
WINDOWS = 5             # timed windows of ITERS batches per QPS figure
REF_CHUNK, REF_B, GT_B = 16_384, 1024, 512
SQ_DIMS, SQ_ADD, SQ_STACK = (64, 128), 262_144, 8
LANES = ("data", "opq_train", "ingest", "ground_truth", "recall", "fast",
         "decoded_cache", "exact", "sq", "parity_sweep", "ingest_u8")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _spread(batch: int, seconds: list) -> tuple[float, list]:
    """QPS of the median window and [slowest, fastest] window QPS."""
    return (batch / float(np.median(seconds)),
            [batch / max(seconds), batch / min(seconds)])


def _windows(fn, stack, consts=()) -> list:
    """Seconds per batch in WINDOWS back-to-back windows over `stack`
    (the first after one warm pass)."""
    return [chained_time(fn, stack, consts=consts, warmup=w == 0)
            for w in range(WINDOWS)]


def load_data(n_db: int, n_queries: int):
    """Lane 1 -> (base [N, 128] f32, queries, top-1 ground truth or None,
    source)."""
    data = load_sift1m()
    if data is not None:
        base, queries, gt = data
        return (base[:n_db], queries[:n_queries], gt[:n_queries, 0],
                "sift1m")
    # fresh-draw queries (independent of the base points): the honest
    # recall regime, like SIFT1M's held-out query set
    base, queries = synthetic_sift(n_db, 128, n_queries=n_queries, seed=0,
                                   query_mode="fresh")
    return base, queries, None, "synthetic-fresh (SIFT1M not on disk)"


def train_opq(base: np.ndarray, n_train: int, dev: torch.device) -> OPQ:
    """Lane 2: OPQ on the first n_train vectors (bench.py's iterations)."""
    return OPQ.train(torch.Generator().manual_seed(0), base[:n_train], m=M,
                     k=KSUB, opq_iters=4, kmeans_iters=6,
                     final_kmeans_iters=12, device=dev)


def ingest(opq: OPQ, base: np.ndarray, n_stage: int):
    """Lane 3 -> (index over base, numbers): host floats to codes, chunk
    by chunk as `add` moves them, then n_stage device rows to codes."""
    dev = opq.device
    warm = FlatADCIndex(opq, impl="kernel")
    warm.add(base[:FlatADCIndex.ENC_CHUNK])
    warm._materialize()
    del warm
    idx = FlatADCIndex(opq, impl="kernel")
    _sync(dev)
    t0 = time.perf_counter()
    for s in range(0, base.shape[0], FlatADCIndex.ENC_CHUNK):
        idx.add(base[s:s + FlatADCIndex.ENC_CHUNK])
    idx._materialize()
    _sync(dev)
    ingest_rate = base.shape[0] / (time.perf_counter() - t0)
    base_dev = torch.from_numpy(base[:n_stage]).to(dev)
    enc = FlatADCIndex(opq, impl="kernel")
    _sync(dev)
    t0 = time.perf_counter()
    enc.add(base_dev)
    enc._materialize()
    _sync(dev)
    return idx, {"ingest_codes_per_sec": ingest_rate,
                 "codes_per_sec": base_dev.shape[0]
                 / (time.perf_counter() - t0)}


def ground_truth(base, queries, n_rec: int, dev: torch.device) -> np.ndarray:
    """Lane 4: exact top-1 of the first n_rec queries (FlatIndex)."""
    exact = FlatIndex(base.shape[1], "l2", chunk=131_072, device=dev)
    exact.add(base)
    return np.concatenate([exact.search(queries[s:min(s + GT_B, n_rec)],
                                        1)[1][:, 0].cpu().numpy()
                           for s in range(0, n_rec, GT_B)])


def reference_ids(idx: FlatADCIndex, queries) -> torch.Tensor:
    """Ids of the independent f32 LUT-ADC engine `_adc_scan` over the
    index's own codes, REF_B queries at a time."""
    n = idx.ntotal
    codes, dsq = idx._padded(-(-n // REF_CHUNK) * REF_CHUNK)
    parts = []
    for s in range(0, len(queries), REF_B):
        qr = idx._rotate(queries[s:s + REF_B])
        parts.append(_adc_scan(qr, torch.sum(qr * qr, -1), codes, dsq,
                               idx.pq.codebooks, K, REF_CHUNK, n)[1])
    return torch.cat(parts)


def recall(idx: FlatADCIndex, queries, gt1: np.ndarray) -> dict:
    """Lane 5: recall of the fast path and of the reference engine on the
    len(gt1) first queries; parity = reference - fast recall@1 in pt."""
    q = queries[:len(gt1)]
    ids_fast = idx.search(q, K)[1].cpu()
    ids_ref = reference_ids(idx, q).cpu()
    out = {"recall_at_1": recall_at_k(ids_fast, gt1, k=1),
           "recall_at_10": recall_at_k(ids_fast, gt1, k=10),
           "recall_at_1_ref_f32_adc": recall_at_k(ids_ref, gt1, k=1),
           "recall_at_10_ref_f32_adc": recall_at_k(ids_ref, gt1, k=10)}
    out["recall_parity_pt"] = 100 * (out["recall_at_1_ref_f32_adc"]
                                     - out["recall_at_1"])
    return dict(out, _ids_fast=ids_fast, _ids_ref=ids_ref)


def query_stack(idx: FlatADCIndex, queries, batch: int,
                iters: int) -> torch.Tensor:
    """[iters, batch, D] rotated queries on the index's device: each batch
    a permutation of the pool (rng seed 0), rotated once."""
    pool = queries if len(queries) >= batch else np.tile(
        queries, (-(-batch // len(queries)), 1))[:batch]
    rng = np.random.default_rng(0)
    stack = np.stack([pool[rng.permutation(len(pool))[:batch]]
                      for _ in range(iters)])
    return idx._rotate(stack)


def fast_qps(idx: FlatADCIndex, stack: torch.Tensor) -> dict:
    """Lane 6: the fast path's QPS over the stack, its effective int8
    rate, and `adc_segmin` alone on the stack's folded queries against
    its bound."""
    codes, dsq, cb_q, srow = idx._kernel_arrays()
    n = idx.ntotal
    batch = stack.shape[1]
    secs = _windows(lambda qb: kernels.adc_search(
        qb, None, codes, dsq, idx.pq.codebooks, K, n, cb_q=cb_q,
        srow=srow), stack)
    qps, spread = _spread(batch, secs)
    folded = [kernels._fold_for(qb, srow, qb.shape[1]) for qb in stack]
    q2s = torch.stack([f[0] for f in folded])
    args = (q2s[0], folded[0][1], codes, cb_q, srow * srow, n,
            kernels.fast_tile_n(codes.shape[0]))
    kernel_ms = 1e3 * float(np.median(_windows(
        lambda q: kernels.adc_segmin(q, *args[1:]), q2s)))
    b = adc_bound(args, cached=False)
    ms = 1e3 * float(np.median(secs))
    return {"value": qps, "value_spread": spread, "ms_per_batch": ms,
            "int8_tops_effective": b["ops"] / (ms / 1e3) / 1e12,
            "adc_segmin_ms": kernel_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"],
            # the card's bound over a time taken on the card only
            "bound_share": (b["bound_ms"] / kernel_ms if codes.is_cuda
                            else None)}


def decoded_cache_qps(idx: FlatADCIndex, stack: torch.Tensor) -> dict:
    """Lane 7: build the int8 decoded cache and time its scan."""
    idx.build_decoded_cache()
    n = idx.ntotal
    secs = _windows(lambda qb: kernels.adc_search_cached(
        qb, idx._dec8_t, idx._norm_col, idx._srow_cache, K, n), stack)
    qps, spread = _spread(stack.shape[1], secs)
    return {"qps_decoded_cache": qps, "qps_decoded_cache_spread": spread}


def exact_lane(idx: FlatADCIndex, stack: torch.Tensor, queries,
               gt1: np.ndarray) -> dict:
    """Lane 8: QPS and recall of exact=True (an f32 re-score of the
    winning segments)."""
    codes, dsq, cb_q, srow = idx._kernel_arrays()
    n = idx.ntotal
    secs = _windows(lambda qb: kernels.adc_search(
        qb, None, codes, dsq, idx.pq.codebooks, K, n, cb_q=cb_q, srow=srow,
        exact=True), stack)
    qps, spread = _spread(stack.shape[1], secs)
    ids = idx.search(queries[:len(gt1)], K, exact=True)[1].cpu()
    return {"qps_exact": qps, "qps_exact_spread": spread,
            "recall_at_1_exact": recall_at_k(ids, gt1, k=1),
            "recall_at_10_exact": recall_at_k(ids, gt1, k=10),
            "_ids_exact": ids}


def sq_index(base, queries, d: int, dev: torch.device):
    """Lane 9's index at width d -> (FlatSQIndex, base rows, queries): the
    first d dimensions L2-normalised on the device, a ScalarQuantizer
    trained on the first N_TRAIN rows."""
    base_sq = l2_normalize(torch.from_numpy(
        np.ascontiguousarray(base[:, :d])).to(dev))
    q_sq = l2_normalize(torch.from_numpy(
        np.ascontiguousarray(queries[:, :d])).to(dev))
    sq = ScalarQuantizer.train(base_sq[:N_TRAIN], l2norm=False)
    sqi = FlatSQIndex(sq, chunk=131_072)
    for s in range(0, len(base_sq), SQ_ADD):
        sqi.add(base_sq[s:s + SQ_ADD])
    return sqi, base_sq, q_sq


def sq_lane(base, queries, d: int, n_rec: int, batch: int,
            dev: torch.device) -> dict:
    """Lane 9 at width d (sq_train.cpp:42-45's operating point is d 64 on
    L2-normalised inputs): ScalarQuantizer + FlatSQIndex, recall of
    search_fast against exact ground truth, QPS of its cached scan (the
    call search_fast makes) on a pool of `batch` queries."""
    sqi, base_sq, q_sq = sq_index(base, queries, d, dev)
    exact = FlatIndex(d, "l2", chunk=131_072, device=dev)
    exact.add(base_sq)
    gt = torch.cat([exact.search(q_sq[s:min(s + GT_B, n_rec)], 1)[1][:, 0]
                    for s in range(0, n_rec, GT_B)]).cpu()
    del exact
    ids = sqi.search_fast(q_sq[:n_rec], K)[1].cpu()
    pool = q_sq.repeat(-(-batch // len(q_sq)), 1)[:batch]
    sq = sqi.sq
    b_vec = sq.bias + 128.0 * sq.scale
    n = sqi.ntotal

    def one(qb, dec8_t, norm_col, srow):
        return kernels.adc_search_cached(qb - b_vec[None, :], dec8_t,
                                         norm_col, srow, K, n)

    secs = _windows(one, torch.stack([pool] * SQ_STACK),
                    consts=(sqi._dec8_t, sqi._norm_col, sq.scale))
    qps, spread = _spread(batch, secs)
    return {f"sq_d{d}_qps": qps, f"sq_d{d}_qps_spread": spread,
            f"sq_d{d}_recall_at_1": recall_at_k(ids, gt, k=1),
            f"sq_d{d}_recall_at_10": recall_at_k(ids, gt, k=10)}


def sweep_data(dist: str, seed: int, n: int) -> np.ndarray:
    """bench.py's sweep data: n rows of one distribution (seeded numpy)."""
    di = ("isotropic", "gmm", "correlated").index(dist)
    rs = np.random.default_rng(seed + 100 * di)
    if dist == "isotropic":
        bs = rs.normal(0, 30, (n, 128))
    elif dist == "gmm":
        cc = rs.gamma(1.2, 24.0, (4096, 128))
        bs = cc[rs.integers(0, 4096, n)] + rs.normal(0, 12, (n, 128))
    else:                               # correlated: low-rank + noise
        w = rs.normal(size=(16, 128))
        bs = rs.normal(size=(n, 16)) @ w * 8 + rs.normal(0, 4, (n, 128))
    return (np.clip(bs, 0, 255).astype(np.float32) if dist != "correlated"
            else bs.astype(np.float32))


def sweep_index(dist: str, seed: int, n_sweep: int, dev: torch.device):
    """One sweep point -> (FlatADCIndex over n_sweep rows, those rows,
    NQ_SWEEP queries): an OPQ trained on the first N_SWEEP_TRAIN rows
    from a torch.Generator seeded with `seed`."""
    bs = sweep_data(dist, seed, n_sweep + NQ_SWEEP)
    b_sw, q_sw = bs[:n_sweep], bs[n_sweep:]
    opq = OPQ.train(torch.Generator().manual_seed(seed),
                    b_sw[:N_SWEEP_TRAIN], m=M, k=KSUB, opq_iters=2,
                    kmeans_iters=3, final_kmeans_iters=4, device=dev)
    idx = FlatADCIndex(opq, impl="kernel")
    idx.add(b_sw)
    return idx, b_sw, q_sw


def parity_sweep(n_sweep: int, dev: torch.device) -> dict:
    """Lane 10: recall@1 parity (reference - fast, pt) over 3
    distributions x 2 seeds. Parity measures the int8 engine against the
    f32 LUT engine on identical codes, which does not need 1M rows; at
    2,048 queries and recall ~0.5 binomial noise is ~1.1 pt (1 sigma),
    so spreads within ~2 pt are sampling noise."""
    sweep = {}
    for dist in ("isotropic", "gmm", "correlated"):
        for seed in (0, 1):
            idx, b_sw, q_sw = sweep_index(dist, seed, n_sweep, dev)
            exact = FlatIndex(128, "l2", chunk=131_072, device=dev)
            exact.add(b_sw)
            gt = exact.search(q_sw, 1)[1][:, 0].cpu()
            del exact
            r1f = recall_at_k(idx.search(q_sw, K)[1].cpu(), gt, k=1)
            r1r = recall_at_k(reference_ids(idx, q_sw).cpu(), gt, k=1)
            sweep[f"{dist}-s{seed}"] = 100 * (r1r - r1f)
    return {"parity_sweep_pt": sweep,
            "parity_spread_pt_max": max(abs(v) for v in sweep.values())}


def ingest_u8(opq: OPQ, base: np.ndarray, n_stage: int) -> dict:
    """Lane 11: n_stage rows as uint8 (SIFT's own type) -> codes, the
    median of WINDOWS passes with the slowest and fastest beside it. On
    the card each chunk is copied from pinned memory on a side stream, so
    the next chunk's copy overlaps this chunk's encode."""
    dev = opq.device
    base_u8 = np.clip(np.rint(base[:n_stage]), 0, 255).astype(np.uint8)
    host = torch.from_numpy(base_u8)
    chunk = FlatADCIndex.ENC_CHUNK
    warm = FlatADCIndex(opq, impl="kernel")
    warm.add(host[:chunk].to(dev).float())
    del warm
    if dev.type == "cuda":
        host = host.pin_memory()
        copy = torch.cuda.Stream(dev)
        compute = torch.cuda.current_stream(dev)

    def rate() -> float:
        enc = FlatADCIndex(opq, impl="kernel")
        _sync(dev)
        t0 = time.perf_counter()
        for s in range(0, len(host), chunk):
            if dev.type == "cuda":
                with torch.cuda.stream(copy):
                    staged = host[s:s + chunk].to(dev, non_blocking=True)
                compute.wait_stream(copy)
                staged.record_stream(compute)
            else:
                staged = host[s:s + chunk]
            enc.add(staged.float())
        enc._materialize()
        _sync(dev)
        return len(host) / (time.perf_counter() - t0)

    rates = sorted(rate() for _ in range(WINDOWS))
    return {"ingest_codes_per_sec_u8": float(np.median(rates)),
            "ingest_codes_per_sec_u8_spread": [rates[0], rates[-1]]}


def _size(value: int | None, env: str, default: int) -> int:
    """A size given to `main`, else the environment variable `env` where
    it is set, else `default`."""
    if value is not None:
        return value
    return int(os.environ.get(env, default))


def _emit(lane: str, numbers: dict) -> None:
    """One lane's JSON line (keys starting with '_' hold arrays and stay
    out of it)."""
    print(json.dumps({"lane": lane, **{k: v for k, v in numbers.items()
                                       if not k.startswith("_")}}),
          flush=True)


def main(device=None, *, n_db: int | None = None, batch: int | None = None,
         iters: int | None = None, n_rec: int | None = None,
         n_sweep: int | None = None, n_stage: int | None = None) -> dict:
    """Run every lane on `device` (the card unless asked for the CPU);
    print a JSON line per lane, then the result object, and return it.
    n_db, batch, iters and n_rec left None read BENCH_N, BENCH_BATCH,
    BENCH_ITERS and BENCH_NREC where those are set, else bench.py's
    sizes; the sweep takes N_SWEEP rows, or n_db where that is fewer;
    n_stage is N_STAGE (every size cut to the rows there are)."""
    dev = resolve_device(device)
    n_db = _size(n_db, "BENCH_N", N_DB)
    batch = _size(batch, "BENCH_BATCH", BATCH)
    iters = _size(iters, "BENCH_ITERS", ITERS)
    n_rec = _size(n_rec, "BENCH_NREC", N_REC)
    n_sweep = min(N_SWEEP, n_db) if n_sweep is None else n_sweep
    n_stage = N_STAGE if n_stage is None else n_stage
    t_start = time.perf_counter()
    launches0 = launch_counts()

    t0 = time.perf_counter()
    base, queries, gt1, source = load_data(n_db, N_QUERIES)
    n_rec = min(n_rec, len(queries))
    _emit("data", {"data": source, "n_db": len(base),
                   "n_queries": len(queries),
                   "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    opq = train_opq(base, N_TRAIN, dev)
    _sync(dev)
    _emit("opq_train", {"seconds": time.perf_counter() - t0})

    idx, res = ingest(opq, base, n_stage)
    _emit("ingest", res)

    t0 = time.perf_counter()
    if gt1 is None:
        gt1 = ground_truth(base, queries, n_rec, dev)
    gt1 = gt1[:n_rec]
    _emit("ground_truth", {"n_rec": n_rec,
                           "seconds": time.perf_counter() - t0})

    out = recall(idx, queries, gt1)
    _emit("recall", out)
    stack = query_stack(idx, queries, batch, iters)
    for lane, fn in (("fast", fast_qps), ("decoded_cache",
                                          decoded_cache_qps)):
        numbers = fn(idx, stack)
        _emit(lane, numbers)
        out.update(numbers)
    numbers = exact_lane(idx, stack, queries, gt1)
    _emit("exact", numbers)
    out.update(numbers)
    del stack

    sq = {}
    for d in SQ_DIMS:
        sq.update(sq_lane(base, queries, d, n_rec, batch, dev))
    _emit("sq", sq)
    sweep = parity_sweep(n_sweep, dev)
    _emit("parity_sweep", sweep)
    u8 = ingest_u8(opq, base, n_stage)
    _emit("ingest_u8", u8)

    result = {
        "metric": "sift1m_adc_qps_per_chip",
        "value": out["value"], "value_spread": out["value_spread"],
        "unit": "qps",
        "recall_at_1": out["recall_at_1"],
        "recall_at_10": out["recall_at_10"],
        "recall_at_1_ref_f32_adc": out["recall_at_1_ref_f32_adc"],
        "recall_at_10_ref_f32_adc": out["recall_at_10_ref_f32_adc"],
        "recall_parity_pt": out["recall_parity_pt"],
        # decoded-cache mode: the fast path's int8 keys over a 16x larger
        # pre-decoded cache (128 MB at 1M x 64-bit codes), no decode
        "qps_decoded_cache": out["qps_decoded_cache"],
        "qps_decoded_cache_spread": out["qps_decoded_cache_spread"],
        # exact=True: f32 re-score of the winning segments
        "qps_exact": out["qps_exact"],
        "qps_exact_spread": out["qps_exact_spread"],
        "recall_at_1_exact": out["recall_at_1_exact"],
        "recall_at_10_exact": out["recall_at_10_exact"],
        "codes_per_sec": res["codes_per_sec"],
        "ingest_codes_per_sec": res["ingest_codes_per_sec"],
        "ingest_codes_per_sec_u8": u8["ingest_codes_per_sec_u8"],
        "ingest_codes_per_sec_u8_spread": u8[
            "ingest_codes_per_sec_u8_spread"],
        # config-1 lane (sq_train.cpp:42-45): int8 SQ flat scan
        "sq_d64_qps": sq["sq_d64_qps"],
        "sq_d64_qps_spread": sq["sq_d64_qps_spread"],
        "sq_d64_recall_at_1": sq["sq_d64_recall_at_1"],
        "sq_d64_recall_at_10": sq["sq_d64_recall_at_10"],
        "sq_d128_qps": sq["sq_d128_qps"],
        "sq_d128_qps_spread": sq["sq_d128_qps_spread"],
        "sq_d128_recall_at_10": sq["sq_d128_recall_at_10"],
        # (f32-ADC reference recall@1 - fast recall@1) pt per distribution
        "parity_sweep_pt": sweep["parity_sweep_pt"],
        "parity_spread_pt_max": sweep["parity_spread_pt_max"],
        "int8_tops_effective": out["int8_tops_effective"],
        "adc_segmin_ms": out["adc_segmin_ms"],
        "bound_ms": out["bound_ms"], "bound_by": out["bound_by"],
        "bound_share": out["bound_share"],
        "launch_overhead_ms": measure_launch_overhead(dev) * 1e3,
        "n_db": len(base), "batch": batch, "code_bits": M * 8,
        "data": source, "ms_per_batch": out["ms_per_batch"],
        "device": card_line(dev) if dev.type == "cuda" else "cpu",
        "kernel_launches": {name: n - launches0[name]
                            for name, n in launch_counts().items()},
        "total_bench_s": time.perf_counter() - t_start,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
