"""HNSW at the reference operating point (`_bench_hnsw.py` on the port):
hnsw_sifts_retrieval/makeIdx.cpp:271-312's recall against latency.

    python -m cvt_tpu_torch.benches.hnsw [corpus.fvecs] [--device cpu]

N 125,402 descriptors, d 128, inner-product space, M 32, efConstruction
80, and makeIdx.cpp's test_vs_recall harness: recall@10 against exact
ground truth (numpy, the brute_force_search role) and microseconds per
query over an ef sweep from 10 to 1,000, single-threaded queries as
makeIdx.cpp's test_approx runs them. The build uses every core
(num_threads=0). The corpus is the .fvecs file given, else
`synthetic_sift` (seed 7), L2-normalised (makeSIFTs.cpp:79-95) so that
inner products rank like cosines.

The graph is host C++ (`native/hnsw.cc`); no kernel runs. The card is
resolved all the same, as by every suite, and named on the result line
beside the host figures.
"""

from __future__ import annotations

import time

import numpy as np

from cvt_tpu_torch.benches._common import Run, emit, parse_args
from cvt_tpu_torch.index.hnsw import HnswIndex
from cvt_tpu_torch.io.datasets import synthetic_sift
from cvt_tpu_torch.io.vecs import read_fvecs

N = 125402          # makeIdx.cpp operating point
D = 128
N_QUERIES = 1000
K = 10
M = 32
EF_C = 80
EF_SWEEP = (10, 20, 40, 80, 160, 320, 640, 1000)
GT_BLOCK, WARM = 128, 32


def load_corpus(path: str | None, n: int = N, n_queries: int = N_QUERIES):
    """(base [n, D], queries [n_queries, D], source), L2-normalised."""
    if path is not None:
        x, src = read_fvecs(path), path
    else:
        x, src = synthetic_sift(n + n_queries, D, seed=7), "synthetic_sift"
    x = np.asarray(x, np.float32)
    x /= np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)
    if len(x) < n + n_queries:
        raise ValueError(f"{src} holds {len(x)} vectors, fewer than "
                         f"{n + n_queries}")
    return x[:n], x[n:n + n_queries], src


def ground_truth(base: np.ndarray, queries: np.ndarray,
                 k: int = K) -> np.ndarray:
    """Exact inner-product top-k [n_queries, k], best first."""
    gt = np.empty((len(queries), k), np.int64)
    for lo in range(0, len(queries), GT_BLOCK):
        s = base @ queries[lo:lo + GT_BLOCK].T          # [N, b]
        part = np.argpartition(-s, k, axis=0)[:k]       # [k, b]
        ordered = part[np.argsort(-s[part, np.arange(s.shape[1])[None, :]],
                                  axis=0), np.arange(s.shape[1])[None, :]]
        gt[lo:lo + GT_BLOCK] = ordered.T
    return gt


def build(base: np.ndarray, num_threads: int = 0) -> tuple[HnswIndex, float]:
    idx = HnswIndex(D, metric="ip", capacity=len(base), m=M,
                    ef_construction=EF_C)
    t0 = time.perf_counter()
    idx.add(base, num_threads=num_threads)
    return idx, time.perf_counter() - t0


def sweep(idx: HnswIndex, queries: np.ndarray, gt: np.ndarray,
          efs=EF_SWEEP) -> list:
    """Per ef: recall@K, microseconds per query (one thread, after a warm
    pass on WARM queries) and the labels."""
    rows = []
    for ef in efs:
        idx.search(queries[:WARM], k=K, ef=ef, num_threads=1)
        t0 = time.perf_counter()
        _, labels = idx.search(queries, k=K, ef=ef, num_threads=1)
        us = (time.perf_counter() - t0) / len(queries) * 1e6
        hit = np.mean([len(set(labels[i]) & set(gt[i])) / K
                       for i in range(len(queries))])
        rows.append({"ef": ef, "recall": float(hit), "us_per_query": us,
                     "_labels": labels})
    return rows


def main(device=None, corpus: str | None = None, *, n: int = N,
         n_queries: int = N_QUERIES, efs=EF_SWEEP) -> dict:
    run = Run("hnsw", device)
    base, queries, src = load_corpus(corpus, n, n_queries)
    emit("corpus", {"corpus": src, "base": list(base.shape),
                    "queries": list(queries.shape)})
    t0 = time.perf_counter()
    gt = ground_truth(base, queries)
    emit("ground_truth", {"seconds": time.perf_counter() - t0})
    idx, build_s = build(base)
    emit("build", {"seconds": build_s, "vecs_per_s": len(base) / build_s,
                   "m": M, "ef_construction": EF_C})
    rows = [emit(f"ef{r['ef']}", r) for r in sweep(idx, queries, gt, efs)]
    return run.result(
        operating_point={"n": len(base), "d": D, "metric": "ip", "m": M,
                         "ef_construction": EF_C, "k": K},
        corpus=src, build_seconds=build_s,
        build_vecs_per_s=len(base) / build_s,
        sweep=[{k: v for k, v in r.items() if not k.startswith("_")}
               for r in rows], kernels={})


if __name__ == "__main__":
    args, device = parse_args(stage_help="an optional corpus .fvecs")
    main(device, *args[:1])
