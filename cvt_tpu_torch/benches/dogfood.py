"""A corpus with real SIFT statistics made by the port's own extractor, and
the config-1 / config-2 recall parity on it (`_bench_dogfood.py` on the
port).

    python -m cvt_tpu_torch.benches.dogfood [extract|parity|all]
        [--device cpu]

SIFT1M cannot be fetched here, so the extractor dogfoods its own data:
`extract_sift` (K 4,096, first octave -1, 2 orientations, RootSIFT) over
`procedural_images(8, 480, 640)` batches until there are N_BASE base
descriptors, then N_QUERY held-out ones from fresh seeds, scaled to
SIFT's uint8 range by the 512x export rule (`to_uint8`, makeSIFTs.cpp's
convention) and written as .bvecs, BASE_NAME and QUERY_NAME in DATA_DIR,
the git-ignored `_data/` (the port's own names: the JAX corpus
`_data/dogfood_*.bvecs` is never read or written here). Host synthesis
and card extraction (the copy to the card, `extract_sift`, the valid rows
back) are timed apart.

`parity` on that corpus, the first N_REC queries against exact top-1
(FlatIndex): config 2, OPQ M 8 (`bench.train_opq`), its fast and
exact=True recall and the f32 LUT-ADC reference engine's (`bench.recall`;
parity in points); config 1, int8 SQ at d 128 on L2-normalised vectors
(`bench.sq_index`: recall of `search_fast`); then `adc_segmin` and
`adc_segmin_cached` alone on the arguments those searches hand them,
beside their bounds, and each against its plain twin on them (the run
stops on a difference).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from cvt_tpu_torch import bench
from cvt_tpu_torch.benches._common import (Run, emit, full_precision,
                                           kernel_lane, parse_args)
from cvt_tpu_torch.features.covdet import extract_sift
from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.io.datasets import procedural_images
from cvt_tpu_torch.io.vecs import read_bvecs, write_bvecs
from cvt_tpu_torch.ops.kernels import recorded_args
from cvt_tpu_torch.utils.metrics import recall_at_k
from cvt_tpu_torch.utils.profile import adc_bound

DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "_data")
BASE_NAME, QUERY_NAME = "torch_dogfood_base.bvecs", "torch_dogfood_query.bvecs"

N_BASE = 1_000_000
N_QUERY = 8192
K_PER_IMAGE = 4096
BATCH = 8
H, W = 480, 640
QUERY_SEED_GAP = 1000
N_REC = 2048
KERNEL_ITERS = 8        # launches per timed window of a kernel alone
OPTS = dict(first_octave=-1, n_orientations=2, rootsift=True)


def to_uint8(desc: np.ndarray) -> np.ndarray:
    """VLFeat / Lowe's 512x export rule: float descriptors -> uint8."""
    return np.clip(np.rint(512.0 * desc), 0, 255).astype(np.uint8)


def generate(dev: torch.device, n_target: int, seed0: int, path: str, *,
             k: int, batch: int, h: int, w: int) -> tuple[dict, int]:
    """Extract batches of seeds seed0, seed0 + 1, ... until n_target
    descriptors; write the first n_target to `path`. -> (times, next
    seed)."""
    chunks, total, seed = [], 0, seed0
    t_host = t_card = 0.0
    t0 = time.perf_counter()
    while total < n_target:
        t = time.perf_counter()
        imgs = procedural_images(batch, h, w, seed=seed)
        t_host += time.perf_counter() - t
        t = time.perf_counter()
        out = extract_sift(torch.from_numpy(imgs).to(dev), max_features=k,
                           **OPTS)
        d = out.descriptors[out.valid].cpu().numpy()
        t_card += time.perf_counter() - t
        chunks.append(to_uint8(d))
        total += len(d)
        seed += 1
    x = np.concatenate(chunks)[:n_target]
    write_bvecs(path, x)
    images = (seed - seed0) * batch
    return {"descriptors": len(x), "images": images,
            "per_image": total / images, "host_synthesis_s": t_host,
            "card_extract_s": t_card,
            "total_s": time.perf_counter() - t0}, seed


def extract(dev: torch.device, *, data_dir: str = DATA_DIR,
            **sizes) -> dict:
    """The base corpus (seeds from 0), then the query corpus from seeds
    past a gap of QUERY_SEED_GAP. `sizes` override the module's sizes
    (n_base, n_query, k, batch, h, w), read when called."""
    s = dict(n_base=N_BASE, n_query=N_QUERY, k=K_PER_IMAGE, batch=BATCH,
             h=H, w=W)
    s.update(sizes)
    n_base, n_query = s.pop("n_base"), s.pop("n_query")
    os.makedirs(data_dir, exist_ok=True)
    base, next_seed = generate(dev, n_base, 0,
                               os.path.join(data_dir, BASE_NAME), **s)
    emit("extract_base", base)
    query, _ = generate(dev, n_query, next_seed + QUERY_SEED_GAP,
                        os.path.join(data_dir, QUERY_NAME), **s)
    emit("extract_query", query)
    return {"base": base, "query": query}


def config2(idx: FlatADCIndex, queries, gt1: np.ndarray) -> dict:
    """Config 2 on an OPQ index: fast, exact=True and reference recall on
    the len(gt1) first queries; parity = reference - fast recall@1, pt."""
    r = bench.recall(idx, queries, gt1)
    ids_ex = idx.search(queries[:len(gt1)], bench.K, exact=True)[1].cpu()
    return {"recall_at_1_fast": r["recall_at_1"],
            "recall_at_10_fast": r["recall_at_10"],
            "recall_at_1_exact": recall_at_k(ids_ex, gt1, k=1),
            "recall_at_1_ref_f32_adc": r["recall_at_1_ref_f32_adc"],
            "recall_at_10_ref_f32_adc": r["recall_at_10_ref_f32_adc"],
            "parity_pt": r["recall_parity_pt"]}


def config1(base, queries, dev: torch.device) -> tuple[dict, tuple]:
    """Config 1: int8 SQ at the corpus's width on L2-normalised vectors
    (`bench.sq_index`), recall of search_fast against exact top-1 ->
    (numbers, (index, normalised queries))."""
    sqi, base_sq, q_sq = bench.sq_index(base, queries, base.shape[1], dev)
    gt = bench.ground_truth(base_sq, q_sq, len(q_sq), dev)
    ids = sqi.search_fast(q_sq, bench.K)[1].cpu()
    return {"recall_at_1": recall_at_k(ids, gt, k=1),
            "recall_at_10": recall_at_k(ids, gt, k=10)}, (sqi, q_sq)


def kernels_at(idx: FlatADCIndex, queries, sqi, q_sq, iters: int) -> dict:
    """Each ADC kernel alone on the arguments a search of every query
    hands it (the OPQ index's fast path, the SQ index's search_fast),
    beside its bound, and against its twin there."""
    dev = q_sq.device
    out = {}
    for name, call, cached in (
            ("adc_segmin", lambda: idx.search(queries, bench.K), False),
            ("adc_segmin_cached", lambda: sqi.search_fast(q_sq, bench.K),
             True)):
        args = recorded_args(name, call)
        out[name] = dict(kernel_lane(name, args,
                                     adc_bound(args, cached=cached), dev,
                                     iters),
                         bpad=args[0].shape[0],
                         npad=args[2].shape[1 if cached else 0])
    return out


def parity(dev: torch.device, *, data_dir: str = DATA_DIR,
           n_rec: int = N_REC, iters: int = KERNEL_ITERS) -> dict:
    """Both configurations on the corpus in `data_dir`, then the kernels
    at their shapes."""
    t0 = time.perf_counter()
    base = read_bvecs(os.path.join(data_dir, BASE_NAME)).astype(np.float32)
    queries = read_bvecs(os.path.join(data_dir, QUERY_NAME)).astype(
        np.float32)[:n_rec]
    gt1 = bench.ground_truth(base, queries, len(queries), dev)
    opq = bench.train_opq(base, bench.N_TRAIN, dev)
    idx = FlatADCIndex(opq, impl="kernel")
    for s in range(0, len(base), FlatADCIndex.ENC_CHUNK):
        idx.add(base[s:s + FlatADCIndex.ENC_CHUNK])
    idx._materialize()
    c2 = emit("config2_opq64", config2(idx, queries, gt1))
    c1, (sqi, q_sq) = config1(base, queries, dev)
    emit("config1_sq_d128", c1)
    kern = kernels_at(idx, queries, sqi, q_sq, iters)
    for name, numbers in kern.items():
        emit(name, numbers)
    return {"corpus": f"extract_sift dogfood ({len(base)} base, "
                      f"{len(queries)} held-out queries)",
            "config2_opq64": c2, "config1_sq_d128": c1,
            "parity_s": time.perf_counter() - t0,
            "kernels": {name: {"ms": k["kernel_ms"], **{
                key: k[key] for key in ("bound_ms", "bound_by",
                                        "bound_share", "bpad", "npad",
                                        "twin")}}
                for name, k in kern.items()}}


def main(device=None, stage: str = "all", *, data_dir: str = DATA_DIR,
         n_rec: int = N_REC, iters: int = KERNEL_ITERS, **sizes) -> dict:
    """Run `stage` (extract, parity or all; the card unless asked for the
    CPU) on the corpus in `data_dir`; `sizes` go to extract (n_base,
    n_query, k, batch, h, w)."""
    if stage not in ("extract", "parity", "all"):
        raise ValueError(f"stage must be extract, parity or all: {stage!r}")
    run = Run("dogfood", device)
    out = {"stage": stage}
    with full_precision():
        if stage in ("extract", "all"):
            out["extract"] = extract(run.dev, data_dir=data_dir, **sizes)
        if stage in ("parity", "all"):
            out.update(parity(run.dev, data_dir=data_dir, n_rec=n_rec,
                              iters=iters))
    kernels = out.pop("kernels", {})
    return run.result(**out, kernels=kernels)


if __name__ == "__main__":
    args, device = parse_args(stage_help="extract | parity | all")
    main(device, *args[:1])
