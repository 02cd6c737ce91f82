"""Where the time of one 1M x 8192 search batch goes on the card.

    python3 _prof_adc_torch.py           # from the repository root

Builds chip_smoke.py's index through its main path (BASELINE config 2:
synthetic_sift 1M x 128, OPQ M = 8, K = 256, 8,192 fresh queries), then
profiles three batches of each search lane (fast, exact, decoded-cache)
and one 1M-row encode with torch.profiler. For each it prints the wall
time per batch (CUDA events), the device time the profiler attributes to
kernels and copies, their ratio (the busy share), and the top device
operations. Then it builds chip_smoke.py's IVF-ADC index (coarseK 8192,
m 16, K 256) on the same base, profiles search_fast at B = 256 for each
nprobe and the reference engine search() at nprobe 16 the same way, and
splits one build into device encode, copy to the host and host layout
(host clock), with the coarse cells' sizes beside the bucket capacity.
Last, chip_smoke.py's SQ lane (1M x 128 L2-normalised: search bf16 and
int8, search_fast at B = 8,192) and its one-card server (serve with each
merge at B = 1,024, on a 1-rank NCCL group), profiled the same way.
Needs one CUDA card.
"""

from __future__ import annotations

import sys
import time

import numpy as np

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke

REPS = 3


def profile_lane(name: str, fn, stamp: str) -> None:
    wall = chip_smoke.cuda_ms(fn, REPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    if not ev:
        raise RuntimeError("the profiler recorded no device operation")
    dev_ms = sum(e.self_device_time_total for e in ev) / 1e3 / REPS
    print(f"{name}: {wall:.3f} ms/batch wall (CUDA events), {dev_ms:.3f} ms "
          f"device time, busy {dev_ms / wall:.1%} {stamp}")
    for e in sorted(ev, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3 / REPS:9.3f} ms "
              f"{e.count / REPS:6.1f}x  {e.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("_prof_adc_torch: no CUDA device; nothing was run")
    from cvt_tpu_torch.index import FlatADCIndex
    from cvt_tpu_torch.io import synthetic_sift
    from cvt_tpu_torch.quant import OPQ

    stamp = f"({chip_smoke.card_line()})"
    torch.set_float32_matmul_precision("highest")
    res = chip_smoke.phase_main_path()
    idx, q = res["_index"], res["_q"]
    dec8 = idx._dec8_n
    idx._dec8_n = None              # hide the cache: the decode kernel's lanes
    profile_lane("fast", lambda: idx.search(q, chip_smoke.K), stamp)
    profile_lane("exact", lambda: idx.search(q, chip_smoke.K, exact=True),
                 stamp)
    idx._dec8_n = dec8
    profile_lane("cached", lambda: idx.search(q, chip_smoke.K), stamp)

    base, _ = synthetic_sift(chip_smoke.N_DB, chip_smoke.D,
                             n_queries=chip_smoke.N_QUERIES,
                             seed=chip_smoke.SEED, query_mode="fresh")
    base = torch.from_numpy(base).to(chip_smoke.DEV)
    opq = OPQ(idx.rotation, idx.pq, device=chip_smoke.DEV)

    def encode():
        e = FlatADCIndex(opq, device=chip_smoke.DEV)
        e.add(base)
        e._materialize()
    profile_lane("encode 1M", encode, stamp)
    profile_ivf(res["_base"], q, res["_gt"], stamp)
    profile_sq_serve(res, stamp)
    return 0


def profile_sq_serve(res, stamp: str) -> None:
    """The SQ lanes at B = 8,192 and the server at B = 1,024."""
    import torch.distributed as dist
    k = chip_smoke.K
    sq = chip_smoke.phase_sq(res["_base"], res["_q"])
    idx, xq = sq["_index"], sq["_xq"]
    for mode in ("bf16", "int8"):
        profile_lane(f"SQ search {mode}",
                     lambda mode=mode: idx[mode].search(xq, k), stamp)
    profile_lane("SQ search_fast", lambda: idx["bf16"].search_fast(xq, k),
                 stamp)
    srv = chip_smoke.phase_serve(res["_index"], res["_q"], res["_gt"],
                                 res["_ids_ref"])["_servers"]
    qb = res["_q"][:chip_smoke.SERVE_B]
    for merge in ("allgather", "ring"):
        profile_lane(f"serve {merge} B={chip_smoke.SERVE_B}",
                     lambda merge=merge: srv[merge].serve(qb, k), stamp)
    dist.destroy_process_group()


def profile_ivf(base, q, gt, stamp: str) -> None:
    """IVF-ADC lanes at B = 256, then one build split by stage."""
    k, b = chip_smoke.K, chip_smoke.IVF_B
    ivf = chip_smoke.phase_ivf(base, q, gt)["_index"]
    qb = q[:b]
    for p in chip_smoke.IVF_NPROBES:
        profile_lane(f"IVF search_fast nprobe {p}",
                     lambda p=p: ivf.search_fast(qb, k, nprobe=p), stamp)
    profile_lane("IVF search nprobe 16",
                 lambda: ivf.search(qb, k, nprobe=16), stamp)

    t0 = time.perf_counter()
    parts = [ivf.encode_chunk(base[s:s + ivf.ENC_CHUNK])
             for s in range(0, base.shape[0], ivf.ENC_CHUNK)]
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = [torch.cat([p[j] for p in parts]).cpu().numpy() for j in range(3)]
    t2 = time.perf_counter()
    ivf.build_from_codes(*host)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    counts = np.bincount(host[0], minlength=ivf.coarse_k)
    cap = ivf._buckets.shape[1]
    print(f"IVF build 1M: encode {t1 - t0:.3f} s, copy {t2 - t1:.3f} s, "
          f"host layout {t3 - t2:.3f} s (host clock) {stamp}")
    print(f"IVF cells: sizes min {counts.min()} median "
          f"{int(np.median(counts))} max {counts.max()}, "
          f"{int((counts > cap).sum())} cells above the bucket cap {cap}, "
          f"tail {int(np.maximum(counts - cap, 0).sum())} {stamp}")


if __name__ == "__main__":
    sys.exit(main())
