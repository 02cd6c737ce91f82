"""Host or device: where one IVF `search_fast` batch spends its time.

    python3 _prof_ivf_host.py            # from the repository root

Builds chip_smoke.py's IVF-ADC index (coarseK 8192, m 16, K 256 on
synthetic_sift 1M x 128, trained on 262,144 vectors) with the
cvt_tpu_torch package of the working directory, then times one
search_fast batch (B = 256, k = 10) at nprobe 8, 16 and 64 three ways:

- wall: calls back to back, timed by CUDA events (chip_smoke.py's
  search_fast time);
- device: the batch enqueued while a spin kernel holds the card, CUDA
  events around the batch alone: the card's time with no host gaps;
- host: the host's time from the call to its return while the card is
  held, which is the time to enqueue the batch.

A batch whose host time reaches the spin's length waited on the card (a
host sync) and fails the run. Medians over REPS batches. Only the public
API is used, so the script can time any commit of the package: copy it
into that commit's checkout and run it there. Needs one CUDA card.
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

import chip_smoke as C

REPS = 30
SPIN_CYCLES = 100_000_000      # ~50 ms at the H100's boost clock


def held_batch(fn) -> tuple[float, float, float]:
    """(host ms, device ms, spin ms) of one fn() enqueued behind a spin."""
    torch.cuda.synchronize()
    e_spin, e0, e1 = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    e_spin.record()
    torch.cuda._sleep(SPIN_CYCLES)
    e0.record()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    e1.record()
    torch.cuda.synchronize()
    return host, e0.elapsed_time(e1), e_spin.elapsed_time(e0)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("_prof_ivf_host: no CUDA device; nothing was run")
    from cvt_tpu_torch.index import IVFADCIndex
    from cvt_tpu_torch.io import synthetic_sift

    torch.set_float32_matmul_precision("highest")
    stamp = f"({C.card_line()})"
    base, queries = synthetic_sift(C.N_DB, C.D, n_queries=C.N_QUERIES,
                                   seed=C.SEED, query_mode="fresh")
    base_dev = torch.from_numpy(base).to(C.DEV)
    q = torch.from_numpy(queries[:C.IVF_B]).to(C.DEV)
    idx = IVFADCIndex(coarse_k=C.IVF_KC, m=C.IVF_M, k=C.KSUB, device=C.DEV)
    idx.train(torch.Generator().manual_seed(C.SEED), base_dev,
              coarse_iters=C.IVF_ITERS, pq_iters=C.IVF_ITERS,
              sample=C.IVF_SAMPLE)
    idx.build(base_dev)

    for p in C.IVF_NPROBES:
        def fn(p=p):
            return idx.search_fast(q, C.K, nprobe=p)
        wall = statistics.median(C.cuda_ms(fn, 10) for _ in range(REPS))
        held = [held_batch(fn) for _ in range(REPS)]
        host, dev, spin = (statistics.median(col) for col in zip(*held))
        worst = max(h / s for h, _, s in held)
        if worst >= 1.0:
            raise AssertionError(f"nprobe {p}: search_fast waited on the "
                                 f"card (host {worst:.0%} of the spin)")
        print(f"IVF search_fast nprobe {p}, B {C.IVF_B}: wall {wall:.4f} ms, "
              f"device {dev:.4f} ms, host enqueue {host:.4f} ms (medians "
              f"of {REPS}; spin {spin:.1f} ms) {stamp}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
