"""The tie-exact top-k against the full stable sort it replaced: alone
across row lengths, then paired on the lanes whose selections it serves.

    python3 _prof_topk_torch.py          # from the repository root

First a sweep of k = 10 over B = 256 and 8,192 rows of N = 64 to 65,536
elements, tie-heavy (integers 0-63 as float32) and continuous (normal)
data: the full stable sort, torch.topk alone, and `ops.topk`'s selection;
and [8,192, 65,536] as the transpose of a [65,536, 8,192] product (the SQ
scan's layout), sorted, selected, and selected after a copy to rows.

Then it builds chip_smoke.py's indexes on synthetic_sift 1M x 128 with the
cvt_tpu_torch package of the working directory (flat OPQ-ADC, the
L2-normalised int8 SQ lane, IVF-ADC at coarseK 8192, m 16), then times
in turns (sort, selection, selection, sort) each lane's batch with
`ops.topk` as it is ("selection") and with every selection forced
through the full stable sort, which is the code the selection replaced
("sort": `_FULL_SORT_SHARE` raised so that every k counts as a large
share of N):

- SQ `search` in bf16 and int8 modes at B = 8,192, k = 10;
- flat fast and exact `search` at B = 8,192, k = 10;
- IVF `search_fast` at B = 256, k = 10, nprobe 8 / 16 / 64, and the
  reference engine `search` at nprobe 16.

Each turn gives the mean of back-to-back calls by CUDA events
(chip_smoke's cuda_ms) after a warm call and, for the IVF lanes, the
medians over 20 batches each enqueued behind a spin kernel
(_prof_ivf_host.py's held_batch) of the card's time with no host gaps
and of the host's time to enqueue the batch.
Every lane's ids and distances must be equal under both selections, or
the run fails. In a checkout older than the selection (no
`_FULL_SORT_SHARE`), both turns run that checkout's sort. Needs one CUDA
card.
"""

from __future__ import annotations

import statistics
import sys

import torch

import chip_smoke as C
from _prof_ivf_host import held_batch

SORT_ALWAYS = 1 << 62
HELD_REPS = 20


def force_sort(topk, on: bool, share) -> None:
    """Send every selection through the full stable sort (on), or restore
    the module's own dispatch; a module without one always sorts."""
    if share is not None:
        topk._FULL_SORT_SHARE = SORT_ALWAYS if on else share


def lanes(base_dev, q_dev):
    """{name: (fn, reps)} over the indexes chip_smoke.py builds."""
    from cvt_tpu_torch.index import FlatADCIndex, FlatSQIndex, IVFADCIndex
    from cvt_tpu_torch.ops.linalg import l2_normalize
    from cvt_tpu_torch.quant import OPQ, ScalarQuantizer
    gen = torch.Generator().manual_seed(C.SEED)
    opq = OPQ.train(gen, base_dev[:C.N_TRAIN].cpu().numpy(), m=C.M,
                    k=C.KSUB, opq_iters=4, kmeans_iters=6,
                    final_kmeans_iters=12, device=C.DEV)
    flat = FlatADCIndex(opq, device=C.DEV)
    flat.add(base_dev)
    xb, xq = l2_normalize(base_dev), l2_normalize(q_dev)
    sq = ScalarQuantizer.train(xb)
    codes = sq.encode(xb)
    sqi = {}
    for mode in ("bf16", "int8"):
        sqi[mode] = FlatSQIndex(sq, mode=mode)
        sqi[mode].add(codes=codes)
    ivf = IVFADCIndex(coarse_k=C.IVF_KC, m=C.IVF_M, k=C.KSUB, device=C.DEV)
    ivf.train(torch.Generator().manual_seed(C.SEED), base_dev,
              coarse_iters=C.IVF_ITERS, pq_iters=C.IVF_ITERS,
              sample=C.IVF_SAMPLE)
    ivf.build(base_dev)
    qi = q_dev[:C.IVF_B]
    out = {f"SQ search {m}": (lambda m=m: sqi[m].search(xq, C.K), 2)
           for m in ("bf16", "int8")}
    out["flat fast"] = (lambda: flat.search(q_dev, C.K), 5)
    out["flat exact"] = (lambda: flat.search(q_dev, C.K, exact=True), 5)
    for p in C.IVF_NPROBES:
        out[f"IVF search_fast nprobe {p}"] = (
            lambda p=p: ivf.search_fast(qi, C.K, nprobe=p)[:2], 10)
    out[f"IVF search nprobe {C.IVF_REF_NPROBE}"] = (
        lambda: ivf.search(qi, C.K, nprobe=C.IVF_REF_NPROBE), 10)
    return out


def sweep(stamp: str) -> None:
    """The selection, torch.topk and the stable sort across row lengths."""
    from cvt_tpu_torch.ops import topk
    g = torch.Generator(device=C.DEV).manual_seed(C.SEED)

    share = getattr(topk, "_FULL_SORT_SHARE", None)

    def time3(x, label: str) -> None:
        def sort():
            force_sort(topk, True, share)
            try:
                return topk.top_k_smallest(x, 10)
            finally:
                force_sort(topk, False, share)
        ms = {"sort": C.cuda_ms(sort, 5),
              "topk": C.cuda_ms(lambda: torch.topk(x, 10, largest=False),
                                5),
              "selection": C.cuda_ms(lambda: topk.top_k_smallest(x, 10), 5)}
        print(f"sweep {label}, k 10: " + ", ".join(
            f"{name} {v:.4f}" for name, v in ms.items()) + f" ms {stamp}")
    for b in (256, 8192):
        for n in (64, 256, 1024, 4096, 16_384, 65_536):
            for data in ("ties", "continuous"):
                x = (torch.randint(0, 64, (b, n), generator=g,
                                   device=C.DEV).float() if data == "ties"
                     else torch.randn((b, n), generator=g, device=C.DEV))
                time3(x, f"[{b}, {n}] {data}")
    xt = torch.randn((65_536, 8192), generator=g, device=C.DEV).T
    time3(xt, "[8192, 65536] continuous, transposed")
    time3(xt.contiguous(), "[8192, 65536] continuous, copied to rows")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("_prof_topk_torch: no CUDA device; nothing was run")
    from cvt_tpu_torch.io import synthetic_sift
    from cvt_tpu_torch.ops import topk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    stamp = f"({C.card_line()})"
    sweep(stamp)
    base, queries = synthetic_sift(C.N_DB, C.D, n_queries=C.N_QUERIES,
                                   seed=C.SEED, query_mode="fresh")
    base_dev = torch.from_numpy(base).to(C.DEV)
    q_dev = torch.from_numpy(queries).to(C.DEV)
    share = getattr(topk, "_FULL_SORT_SHARE", None)
    for name, (fn, reps) in lanes(base_dev, q_dev).items():
        turns, results = [], {}
        for label in ("sort", "selection", "selection", "sort"):
            force_sort(topk, label == "sort", share)
            results[label] = fn()
            wall = C.cuda_ms(fn, reps)
            held = ""
            if name.startswith("IVF"):
                host, dev = (statistics.median(col) for col in zip(
                    *[held_batch(fn)[:2] for _ in range(HELD_REPS)]))
                held = f" (device {dev:.3f}, host {host:.3f})"
            turns.append(f"{label} {wall:.3f}{held}")
        force_sort(topk, False, share)
        for a, b in zip(results["sort"], results["selection"]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: the selection's results "
                                     f"differ from the sort's")
        print(f"{name}: " + ", ".join(turns) + f" ms/batch (sort, "
              f"selection, selection, sort); results equal {stamp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
