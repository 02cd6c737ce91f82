"""The 1,048,576-word vocabulary tree end to end (`_bench_vocab.py` on the
port): the retriever's Flickr100K tree size (exe/vocab_tree.cc:74-78,
visual_index.h:624-665).

    python -m cvt_tpu_torch.benches.vocab [--device cpu]
    VOCAB_BENCH_SMALL=1: W 4,096 on 32,768 descriptors, 16 images x 64,
    4 queries

On host numpy data drawn as the script draws it (seed 0: gamma centres,
a SIFT-like mixture; each corpus image samples 24 of the clusters, so its
words look like a real image's):

  1. train the hierarchical 1024 x 1024 vocabulary (probes 0: the corpus
     is assigned exactly) on N_TRAIN descriptors;
  2. the exact `kmeans_assign_blocked` of every training descriptor to
     every word (1M x 1M x 128: ~2.7e14 float32 operations, TF32 off);
  3. multi-probe `hierarchical_assign` at probes 8 and 16 on a 100,000
     slice, and its agreement with the exact assignment;
  4. add and prepare N_IMAGES images x K_FEAT;
  5. N_QUERIES noisy single-image `query` calls (30% feature dropout,
     noise 18) at probes 0 / 4 / 8 / 16 and exact + verify=10: recall@1
     of the source image and latency per query (host clock).

Peak device memory is reported. Nothing is written to disk (BENCH_VOCAB.md
holds the TPU's figures).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from cvt_tpu_torch.benches._common import (Run, emit, full_precision,
                                           parse_args, peak_mib, reset_peak,
                                           sync)
from cvt_tpu_torch.index.vocab_he import VocabHEIndex
from cvt_tpu_torch.ops.kmeans import hierarchical_assign, kmeans_assign_blocked

FULL = dict(w=1_048_576, n_train=1_048_576, n_images=256, k_feat=512,
            n_queries=48, n_clusters=65_536)
SMALL = dict(w=4_096, n_train=32_768, n_images=16, k_feat=64, n_queries=4,
             n_clusters=2_048)
CTRL, ITERS, SCENE, QUERY_PROBES, VERIFY = 100_000, 10, 24, (0, 4, 8, 16), \
    10


class Mixture:
    """The script's data: its numpy stream (seed 0) draws the centres, then
    the training rows; images come from their own seeds."""

    def __init__(self, n_clusters: int, k_feat: int):
        self.rng = np.random.default_rng(0)
        self.k_feat = k_feat
        self.centers = self.rng.gamma(
            1.2, 24.0, size=(n_clusters, 128)).astype(np.float32)

    def draw(self, m: int) -> np.ndarray:
        ci = self.rng.integers(0, len(self.centers), size=m)
        x = self.centers[ci] + self.rng.normal(0, 12.0, size=(m, 128))
        return np.clip(x, 0, 255).astype(np.float32)

    def image(self, seed: int):
        """(descriptors [k_feat, 128], geometries [k_feat, 4]) of one
        image: k_feat draws from SCENE of the clusters."""
        r = np.random.default_rng(seed)
        k = self.k_feat
        scene = r.choice(len(self.centers), size=SCENE, replace=False)
        ci = r.choice(scene, size=k)
        desc = np.clip(self.centers[ci] + r.normal(0, 12.0, (k, 128)),
                       0, 255).astype(np.float32)
        geom = np.stack([r.uniform(0, 1024, k), r.uniform(0, 1024, k),
                         r.uniform(2, 8, k), r.uniform(-3, 3, k)],
                        1).astype(np.float32)
        return desc, geom


def run_queries(idx: VocabHEIndex, images: list, n_queries: int,
                probes: int, verify: int = 0) -> tuple[float, float]:
    """Noisy re-renders of corpus images -> (recall@1 of the source image,
    seconds per query)."""
    idx.probes = probes
    n_images, k = len(images), images[0][0].shape[0]
    hits, t_q = 0, 0.0
    for i in range(n_queries):
        src = i * (n_images // n_queries)
        d, g = images[src]
        r = np.random.default_rng(9000 + i)
        keep = r.random(k) < 0.7
        qd = np.clip(d + r.normal(0, 18.0, d.shape), 0, 255)
        t0 = time.perf_counter()
        names, _ = idx.query(qd.astype(np.float32), topk=5, valid=keep,
                             geometries=g if verify else None,
                             verify=verify)
        t_q += time.perf_counter() - t0
        hits += names[0] == f"im{src}"
    return hits / n_queries, t_q / n_queries


def main(device=None, *, small: bool | None = None, **sizes) -> dict:
    """Every stage (the card unless asked for the CPU) at the full size,
    or SMALL where `small` or VOCAB_BENCH_SMALL says so; `sizes` override
    single entries (w, n_train, n_images, k_feat, n_queries,
    n_clusters)."""
    if small is None:
        small = bool(int(os.environ.get("VOCAB_BENCH_SMALL", "0")))
    s = dict(SMALL if small else FULL, **sizes)
    run = Run("vocab", device)
    dev = run.dev
    with full_precision():
        out = stages(dev, s)
    return run.result(small=small, sizes=s, **out, kernels={})


def stages(dev: torch.device, s: dict) -> dict:
    mix = Mixture(s["n_clusters"], s["k_feat"])
    train = torch.from_numpy(mix.draw(s["n_train"])).to(dev)
    reset_peak(dev)
    idx = VocabHEIndex(n_words=s["w"], probes=0, hierarchical=True,
                       device=dev)
    t0 = time.perf_counter()
    idx.train(torch.Generator().manual_seed(0), train, iters=ITERS)
    sync(dev)
    out = {"train": emit("train", {"seconds": time.perf_counter() - t0})}

    t0 = time.perf_counter()
    exact, _ = kmeans_assign_blocked(train, idx.words)
    sync(dev)
    t = time.perf_counter() - t0
    n, w = train.shape[0], idx.words.shape[0]
    out["exact_assign"] = emit("exact_assign", {
        "seconds": t, "desc_per_s": n / t,
        "fp32_tflops": 2.0 * n * w * train.shape[1] / t / 1e12})

    ctrl = train[:min(CTRL, n)]
    t0 = time.perf_counter()
    a8, _ = hierarchical_assign(ctrl, idx.coarse, idx.fine, probes=8)
    sync(dev)
    t8 = time.perf_counter() - t0
    a16, _ = hierarchical_assign(ctrl, idx.coarse, idx.fine, probes=16)
    ex = exact[:len(ctrl)]
    out["multiprobe"] = emit("multiprobe", {
        "n": len(ctrl), "probes8_s": t8,
        "agree8": float((a8 == ex).float().mean()),
        "agree16": float((a16 == ex).float().mean())})
    del train, exact

    images = [mix.image(1000 + i) for i in range(s["n_images"])]
    t0 = time.perf_counter()
    for i, (d, g) in enumerate(images):
        idx.add_image(d, name=f"im{i}", geometries=g)
    sync(dev)
    t_add = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx.prepare()
    sync(dev)
    out["add_prepare"] = emit("add_prepare", {
        "add_s": t_add, "prepare_s": time.perf_counter() - t0,
        "bucket_cap": idx._b_img.shape[1], "overflow": idx.n_overflow})

    queries = {}
    for probes in QUERY_PROBES:
        r, lat = run_queries(idx, images, s["n_queries"], probes)
        label = "exact" if probes == 0 else f"probes={probes}"
        queries[label] = emit(f"query_{label}", {"recall_at_1": r,
                                                 "ms_per_query": lat * 1e3})
    r, lat = run_queries(idx, images, s["n_queries"], 0, verify=VERIFY)
    queries[f"exact+verify{VERIFY}"] = emit(
        f"query_exact+verify{VERIFY}", {"recall_at_1": r,
                                        "ms_per_query": lat * 1e3})
    return dict(out, queries=queries, peak_mib=peak_mib(dev))


if __name__ == "__main__":
    _, device = parse_args()
    main(device)
