"""Probes behind chip_smoke.py's step 26 (records -> ArcFace -> indexes)
and its step 12 score check.

    python3 _prof_records_torch.py rehearse   # the CPU, reduced size
    python3 _prof_records_torch.py hnsw       # the CPU, 100,000 vectors
    python3 _prof_records_torch.py vocab      # the card: step 12 x 4

rehearse: step 26 on the CPU (`chip_smoke.run_records_training` with
  DEV "cpu", the card's clocks stubbed, the kernel wrappers counted) at
  2,048 -> 512 over 8,192 classes, 256 identities, batch 128, HNSW over
  20,000 synthetic vectors. Prints the step's lines; the gates apply.
hnsw: HnswIndex(l2, M 32, efC 80) over synthetic_sift(100,000) drawn from
  62,500 clusters, the density of the first 100,000 of step 26's 1M base;
  recall@10 (the true nearest within the 10 returned), 10@10 and
  recall@1 at ef 100 and 200 against an exact scan.
vocab: step 12 (the vocabulary tree) four times in one process on the
  card, the last two with cuDNN's legacy TF32 flag off as earlier
  versions of chip_smoke.py set it; prints each run's verdict and the
  worst relative score difference of each card-against-CPU check.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

import chip_smoke as cs


def rehearse() -> None:
    from cvt_tpu_torch.io import synthetic_sift
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.parallel import sharded_search as SS

    class Event:
        def __init__(self, **_):
            self.t = 0.0

        def record(self):
            self.t = time.perf_counter()

        def synchronize(self):
            pass

        def elapsed_time(self, other):
            return (other.t - self.t) * 1e3

    def counted(fn):
        def call(*a, **k):
            call.launches += 1
            return fn(*a, **k)
        call.launches, call.__name__ = 0, fn.__name__
        return call

    cs.DEV = "cpu"
    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.Event = Event
    # on the CPU the wrappers run their twins, which count no launch
    T.adc_segmin_cached = counted(T.adc_segmin_cached)
    T.adc_segmin = SS.adc_segmin = counted(T.adc_segmin)
    cs.cuda_median_ms = lambda fn, reps: (cs.timed(fn)[1] * 1e3, [])
    cs.ARC_IN, cs.ARC_CLASSES, cs.ARC_IDS, cs.ARC_B = 2048, 8192, 256, 128
    cs.HNSW_N, cs.N_REC = 20_000, 256
    base, q = synthetic_sift(cs.HNSW_N, cs.D, n_queries=cs.N_REC,
                             n_clusters=cs.HNSW_N * 10 // 16, seed=cs.SEED)
    cs.run_records_training("(CPU rehearsal)", torch.from_numpy(base),
                            torch.from_numpy(q))


def hnsw() -> None:
    from cvt_tpu_torch.index import HnswIndex
    from cvt_tpu_torch.io import synthetic_sift
    from cvt_tpu_torch.utils import recall_at_k
    base, q = synthetic_sift(cs.HNSW_N, cs.D, n_queries=1024,
                             n_clusters=62_500, seed=cs.SEED)
    idx = HnswIndex(cs.D, metric="l2", capacity=len(base), m=cs.HNSW_M,
                    ef_construction=cs.HNSW_EFC)
    t0 = time.perf_counter()
    idx.add(base)
    print(f"build {len(base) / (time.perf_counter() - t0):.0f} vectors/s "
          f"(host)")
    d = ((q ** 2).sum(1)[:, None] - 2 * q @ base.T
         + (base ** 2).sum(1)[None])
    gt = np.argsort(d, 1)[:, :10]
    for ef in (cs.HNSW_EF, 2 * cs.HNSW_EF):
        _, ids = idx.search(q, 10, ef=ef)
        print(f"ef {ef}: recall@10 {recall_at_k(ids, gt[:, 0], k=10):.4f}, "
              f"10@10 {recall_at_k(ids, gt, k=10, gt_count=10):.4f}, "
              f"recall@1 {recall_at_k(ids, gt[:, 0], k=1):.4f}")


def vocab() -> None:
    from cvt_tpu_torch.ops.kernels import _build
    card = cs.card_line()
    stamp = f"({card})"
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _build.load()
    agree, worst = cs.rankings_agree, []

    def spy(ids_a, sc_a, ids_b, sc_b, k, atol=1e-7):
        sa, sb = np.asarray(sc_a)[:, :k], np.asarray(sc_b)[:, :k]
        worst.append(float(np.max(np.abs(sb - sa)
                                  / np.maximum(np.abs(sa), 1e-12))))
        return agree(ids_a, sc_a, ids_b, sc_b, k, atol)
    cs.rankings_agree = spy
    for run in range(4):
        if run == 2:
            torch.backends.cudnn.allow_tf32 = False
        worst.clear()
        try:
            cs.phase_vocab(stamp)
            verdict = "pass"
        except AssertionError as e:
            verdict = "FAIL " + str(e).strip().splitlines()[0][:200]
        print(f"run {run} (legacy cuDNN TF32 off: {run >= 2}): {verdict}; "
              f"worst relative score difference per check {worst} {stamp}")


if __name__ == "__main__":
    probes = {"rehearse": rehearse, "hnsw": hnsw, "vocab": vocab}
    if len(sys.argv) != 2 or sys.argv[1] not in probes:
        raise SystemExit(f"usage: python3 {sys.argv[0]} "
                         f"{{{','.join(probes)}}}")
    probes[sys.argv[1]]()
