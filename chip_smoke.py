"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

1. Card and kernels: refuses to run without CUDA; prints the card's name
   and power limit (nvidia-smi); pins float32 matrix products to full
   precision; builds the CUDA kernels from csrc/ (timed).
2. Kernel against twin on seeded random inputs: both ADC kernels and
   their plain PyTorch twins (Npad = 65,536, B = 1,024, D = 128, M = 8,
   K = 256).
3. Main path at the real size (BASELINE config 2 at bench.py's settings):
   synthetic_sift(1M, 128, 8192 fresh queries) -> OPQ.train(M=8, K=256)
   on 131,072 vectors -> FlatADCIndex(device="cuda").add -> exact ground
   truth (FlatIndex, 2,048 queries) -> search fast and exact=True at
   B = 8,192 -> build_decoded_cache + search -> the reference engine
   `_adc_scan`'s recall as the parity reference.
4. Asserts: both kernels launched during the main path; decoded-cache ids
   equal the fast path's; |recall@1(fast) - recall@1(reference)| <= 1.0
   point; every id below n and every distance finite.
5. Kernel against twin at the main path's own arguments: the index's
   codes, decoded cache and norms, the 8,192 folded queries, and the
   tiles the index picks at 1M (2,048 for the decode scan, 4,096 for the
   cached scan). The `kernels` line reports this comparison.
6. Times (CUDA events) of fast, exact and decoded-cache search at 1M x
   8192, of each kernel beside its twin, and encode codes/s.
7. IVF-ADC at the reference operating point (coarseK 8192, m 16, K 256,
   opq/src/IVFOPQ.cpp:56-63) on the same 1M base, queries and ground
   truth: the `ivf_page` kernel against its twin on seeded random inputs
   (pad rows, masked segments, Bpad > B); IVFADCIndex.train on 262,144
   vectors (10 + 10 iterations) -> build (codes/s) -> search_fast at
   B = 256, k = 10, nprobe 8 / 16 / 64 over 2,048 queries -> the reference
   engine search() at nprobe 16. Asserts: the kernel launched, no page
   dropped, ids in [0, n) or -1 without duplicates, finite distances,
   |recall@10(search_fast) - recall@10(search)| <= 1.0 point at nprobe 16.
   Then the kernel against its twin on one nprobe-16 batch's own
   arguments, and times (CUDA events) of search_fast, search() and the
   kernel beside its twin.
8. One JSON line describing the three kernels and, last, the device line.

Every ADC kernel-against-twin check demands segpack and tiletop bitwise
equal, except that a row whose norm/qs lies within 1e-4 of a half-integer
may move its key by seg (float32 summation order); such rows are counted
and printed. The IVF kernel sums no floats, so it must equal its twin
bitwise everywhere. Any failure raises, so the exit code is non-zero and
no result is printed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

SEED = 0
N_DB, N_QUERIES, N_TRAIN, N_REC = 1_000_000, 8192, 131_072, 2048
D, M, KSUB, K = 128, 8, 256, 10
DEV = "cuda"
KERNEL_SRC = "cvt_tpu_torch/csrc/adc_scan.cu"
IVF_SRC = "cvt_tpu_torch/csrc/ivf_scan.cu"
# IVF-ADC at the reference operating point (_bench_ivf.py:63-64's training)
IVF_KC, IVF_M, IVF_SAMPLE, IVF_ITERS, IVF_B = 8192, 16, 262_144, 10, 256
IVF_NPROBES, IVF_REF_NPROBE = (8, 16, 64), 16


def card_line() -> str:
    """'<name>, <power limit>' of card 0, as nvidia-smi prints it."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call from CUDA events, after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_kernel_args(npad: int, b: int, n_valid: int):
    """Seeded random arguments for both kernels, plus the norm column
    (D = 128, M = 8, K = 256)."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    g = torch.Generator().manual_seed(SEED)
    cb = torch.randn((M, KSUB, D // M), generator=g) * 20
    cb_q, srow = T._quantize_codebooks(cb)
    codes = torch.randint(0, KSUB, (npad, M), generator=g,
                          dtype=torch.uint8).to(DEV)
    q = (torch.randn((b, D), generator=g) * 50).to(DEV)
    cb_q, srow = cb_q.to(DEV), srow.to(DEV)
    s2 = srow * srow
    q2s, qs = T._fold_for(q, srow, D)
    dec = T.decode_int8(codes, cb_q)
    norm_col = T._row_norms(dec, s2)[:, None].contiguous()
    dec_args = (q2s, qs, codes, cb_q, s2, n_valid, T.fast_tile_n(npad))
    cached_args = (q2s, qs, dec.T.contiguous(), norm_col, n_valid,
                   T.cached_tile_n(npad))
    return dec_args, cached_args, norm_col[:, 0]


def main_path_kernel_args(idx, q_dev):
    """The arguments the index's search gives each kernel: the decode
    scan's (fast and exact lanes) and the decoded-cache scan's, each with
    its own query fold and tile."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    n = idx.ntotal
    codes, _, cb_q, srow = idx._kernel_arrays()
    qr = idx._rotate(q_dev)
    q2s, qs = T._fold_for(qr, srow, D)
    dec_args = (q2s, qs, codes, cb_q, srow * srow, n,
                T.fast_tile_n(codes.shape[0]))
    vcap, _ = T._pack_caps(T.SEG, D)
    q2s_c, qs_c = T._fold_queries(qr, idx._srow_cache,
                                  torch.amax(idx._norm_col), vcap)
    cached_args = (q2s_c, qs_c, idx._dec8_t, idx._norm_col, n,
                   T.cached_tile_n(idx._dec8_t.shape[1]))
    return dec_args, cached_args


def compare_kernel_to_twin(kernel, twin, args, norm, qs, tile_n) -> dict:
    """Run a kernel and its twin on the same arguments. Differences are
    allowed only in segments (and tiles) holding a row whose norm/qs lies
    within 1e-4 of a half-integer, and a segment minimum may move by at
    most seg; anything else raises."""
    from cvt_tpu_torch.ops.kernels.adc_scan import SEG
    r = norm.double() / float(qs)
    near_half = torch.nonzero((r - torch.floor(r) - 0.5).abs() < 1e-4)[:, 0]
    got = kernel(*args)
    want = twin(*args)
    max_err, n_diff = 0, 0
    for a, b, rows in zip(got, want, (SEG, tile_n)):
        allowed = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
        allowed[near_half // rows] = True
        diff = (a.long() - b.long()).abs()
        bad = diff.flatten(1).amax(1) > 0
        n_diff += int(bad.sum())
        if bool((bad & ~allowed).any()):
            raise AssertionError(f"{kernel.__name__}: kernel differs from "
                                 f"its twin outside near-half rows")
        max_err = max(max_err, int(diff.max()))
    if int((got[0].long() - want[0].long()).abs().max()) > SEG:
        raise AssertionError(f"{kernel.__name__}: segpack off by > seg")
    return {"near_half_rows": int(near_half.numel()), "max_abs_err": max_err,
            "rows_differ": n_diff}


def compare_both(dec_args, cached_args, dec_norm) -> dict:
    """Both kernels against their twins; the decode kernel's in-kernel
    norm is `dec_norm`, the cached kernel reads its norm column."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    return {
        "adc_segmin": compare_kernel_to_twin(
            T.adc_segmin, T.adc_segmin_plain, dec_args, dec_norm,
            dec_args[1], dec_args[-1]),
        "adc_segmin_cached": compare_kernel_to_twin(
            T.adc_segmin_cached, T.adc_segmin_cached_plain, cached_args,
            cached_args[3][:, 0], cached_args[1], cached_args[-1])}


def phase_main_path() -> dict:
    """Steps 3-4: the port's main path through its public entry points."""
    from cvt_tpu_torch.index import FlatADCIndex, FlatIndex
    from cvt_tpu_torch.index.flat_adc import _adc_scan
    from cvt_tpu_torch.io import synthetic_sift
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.quant import OPQ
    from cvt_tpu_torch.utils import recall_at_k

    T.adc_segmin.launches = 0
    T.adc_segmin_cached.launches = 0
    res = {}
    t0 = time.perf_counter()
    base, queries = synthetic_sift(N_DB, D, n_queries=N_QUERIES, seed=SEED,
                                   query_mode="fresh")
    res["data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    opq = OPQ.train(torch.Generator().manual_seed(SEED), base[:N_TRAIN],
                    m=M, k=KSUB, opq_iters=4, kmeans_iters=6,
                    final_kmeans_iters=12, device=DEV)
    torch.cuda.synchronize()
    res["opq_train_s"] = time.perf_counter() - t0

    base_dev = torch.from_numpy(base).to(DEV)
    q_dev = torch.from_numpy(queries).to(DEV)
    warm = FlatADCIndex(opq, device=DEV)
    warm.add(base_dev[:FlatADCIndex.ENC_CHUNK])
    warm._materialize()
    torch.cuda.synchronize()
    del warm

    idx = FlatADCIndex(opq, device=DEV)
    t0 = time.perf_counter()
    idx.add(base_dev)
    idx._materialize()
    torch.cuda.synchronize()
    res["encode_codes_per_s"] = N_DB / (time.perf_counter() - t0)
    assert idx._resolve_impl() == "kernel"

    exact_index = FlatIndex(D, "l2", chunk=131_072, device=DEV)
    exact_index.add(base_dev)
    gt = torch.cat([exact_index.search(q_dev[s:min(s + 512, N_REC)], 1)[1]
                    for s in range(0, N_REC, 512)])[:, 0].cpu()
    del exact_index

    d_fast, i_fast = idx.search(q_dev, K)
    d_exact, i_exact = idx.search(q_dev, K, exact=True)
    # the reference engine over the same codes, as bench.py scores parity
    n = idx.ntotal
    npad_ref = -(-n // 16384) * 16384
    codes_ref, dsq_ref = idx._padded(npad_ref)
    ids_ref = []
    for s in range(0, N_REC, 1024):
        qr = idx._rotate(q_dev[s:min(s + 1024, N_REC)])
        ids_ref.append(_adc_scan(qr, torch.sum(qr * qr, -1), codes_ref,
                                 dsq_ref, opq.pq.codebooks, K, 16384,
                                 n)[1])
    ids_ref = torch.cat(ids_ref)
    idx.build_decoded_cache()
    d_cached, i_cached = idx.search(q_dev, K)
    torch.cuda.synchronize()
    res["launches"] = {"adc_segmin": T.adc_segmin.launches,
                       "adc_segmin_cached": T.adc_segmin_cached.launches}

    for name, ids in (("fast", i_fast), ("exact", i_exact),
                      ("reference", ids_ref)):
        res[f"recall_at_1_{name}"] = recall_at_k(ids[:N_REC], gt, k=1)
        res[f"recall_at_10_{name}"] = recall_at_k(ids[:N_REC], gt, k=10)
    res["parity_pt"] = 100 * (res["recall_at_1_reference"]
                              - res["recall_at_1_fast"])
    for name, (d, i) in (("fast", (d_fast, i_fast)),
                         ("exact", (d_exact, i_exact)),
                         ("cached", (d_cached, i_cached))):
        assert i.shape == (N_QUERIES, K), name
        assert int(i.max()) < n and int(i.min()) >= 0, name
        assert bool(torch.isfinite(d).all()), name
    # top-1 is exact in both by the segment lemma; the cached scan takes a
    # larger tile (4096) at 1M, so for k > 1 the best-two-per-tile cap can
    # differ: compare all k ids at the fast path's tile as well
    res["cached_top1_equal"] = bool(torch.equal(i_cached[:, 0],
                                                i_fast[:, 0]))
    res["cached_all_ids_equal_frac"] = float(
        (i_cached == i_fast).float().mean())
    qr = idx._rotate(q_dev)
    _, i_same_tile = T.adc_search_cached(
        qr, idx._dec8_t, idx._norm_col, idx._srow_cache, K, n,
        tile_n=T.fast_tile_n(idx._dec8_t.shape[1]))
    res["cached_same_tile_ids_equal"] = bool(torch.equal(i_same_tile,
                                                         i_fast))
    assert res["launches"]["adc_segmin"] > 0
    assert res["launches"]["adc_segmin_cached"] > 0
    assert res["cached_top1_equal"], "decoded-cache top-1 != fast top-1"
    assert res["cached_same_tile_ids_equal"], "decoded-cache ids != fast"
    assert abs(res["parity_pt"]) <= 1.0, res["parity_pt"]
    res["_index"], res["_q"], res["_base"], res["_gt"] = (idx, q_dev,
                                                          base_dev, gt)
    return res


def phase_timing(idx, q_dev, dec_args, cached_args, reps: int) -> dict:
    """Step 6: CUDA-event times at the main path's shapes."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    out = {}
    # the index scans its decoded cache while _dec8_n matches its size:
    # hide the cache to time the decode kernel's fast and exact paths
    dec8 = idx._dec8_n
    idx._dec8_n = None
    out["fast_ms"] = cuda_ms(lambda: idx.search(q_dev, K), reps)
    out["exact_ms"] = cuda_ms(lambda: idx.search(q_dev, K, exact=True),
                              reps)
    idx._dec8_n = dec8
    out["cached_ms"] = cuda_ms(lambda: idx.search(q_dev, K), reps)
    out["adc_segmin_ms"] = cuda_ms(lambda: T.adc_segmin(*dec_args), reps)
    out["adc_segmin_plain_ms"] = cuda_ms(
        lambda: T.adc_segmin_plain(*dec_args), 1)
    out["adc_segmin_cached_ms"] = cuda_ms(
        lambda: T.adc_segmin_cached(*cached_args), reps)
    out["adc_segmin_cached_plain_ms"] = cuda_ms(
        lambda: T.adc_segmin_cached_plain(*cached_args), 1)
    return out


def random_ivf_args(d: int, b: int, seed: int = SEED):
    """Seeded ivf_page arguments over 64 pages of 512 rows (seg 32) for a
    batch of b queries: BIG pad rows and a whole page of them, BIG-masked
    cip entries and padded query columns, a repeated fill page in sel."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    g = torch.Generator().manual_seed(seed)
    nvcap, _ = V._ivf_pack_caps(32, d)
    lp, spt, n_pages, s = 512, 16, 64, 48
    bpad = -(-b // 128) * 128
    qs = torch.rand((1,), generator=g) + 0.5
    dec8_t = torch.randint(-127, 128, (d, n_pages * lp), generator=g,
                           dtype=torch.int8)
    nrm = torch.rand((n_pages * lp, 1), generator=g) * 0.9 * nvcap * qs
    nrm[torch.rand(nrm.shape, generator=g) < 0.1] = V.BIG
    nrm[5 * lp:6 * lp] = V.BIG
    sel = torch.randperm(n_pages, generator=g)[:s].to(torch.int32)
    sel[-4:] = 0
    cip = torch.rand((s * spt, bpad), generator=g) * 0.9 * 127 ** 2 * d * qs
    cip[torch.rand(cip.shape, generator=g) < 0.3] = V.BIG
    cip[-4 * spt:] = V.BIG
    cip[:, b:] = V.BIG
    q2s = torch.randint(-127, 128, (bpad, d), generator=g, dtype=torch.int8)
    q2s[b:] = 0
    return [x.to(DEV) for x in (q2s, qs, dec8_t, nrm, cip, sel)] + [lp, 32]


def compare_ivf_kernel(args) -> dict:
    """The ivf_page kernel against its twin on the same arguments:
    bitwise, or raise."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    got = V.ivf_pages_segmin(*args)
    want = V.ivf_pages_segmin_plain(*args)
    err = int((got.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"ivf_page kernel differs from its twin by "
                             f"{err}")
    return {"max_abs_err": err, "shape": list(got.shape)}


def ivf_batches(idx, q_dev, fn):
    """fn(idx, batch) over the first N_REC queries in batches of IVF_B;
    the results concatenated."""
    outs = [fn(idx, q_dev[s:s + IVF_B]) for s in range(0, N_REC, IVF_B)]
    return [torch.cat([o[j] for o in outs]) for j in range(len(outs[0]))]


def fast_batch(idx, q, nprobe: int):
    """search_fast on one batch -> (dists, ids, n_dropped as [1])."""
    d, i, dropped = idx.search_fast(q, K, nprobe=nprobe)
    return d, i, dropped.reshape(1)


def check_ids(d, i, n: int, name: str) -> None:
    """ids in [0, n) or -1, no duplicate id in a row, finite distances
    wherever an id is given."""
    ic = i.cpu().numpy()
    assert ((ic >= 0) & (ic < n) | (ic == -1)).all(), name
    for row in ic:
        v = row[row >= 0]
        assert len(set(v.tolist())) == len(v), name
    assert bool(torch.isfinite(d[i >= 0]).all()), name


def phase_ivf(base_dev, q_dev, gt) -> dict:
    """Step 7's main path: train, build, search_fast, search."""
    from cvt_tpu_torch.index import IVFADCIndex
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    from cvt_tpu_torch.utils import recall_at_k
    res = {}
    idx = IVFADCIndex(coarse_k=IVF_KC, m=IVF_M, k=KSUB, device=DEV)
    t0 = time.perf_counter()
    idx.train(torch.Generator().manual_seed(SEED), base_dev,
              coarse_iters=IVF_ITERS, pq_iters=IVF_ITERS, sample=IVF_SAMPLE)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    idx.encode_chunk(base_dev[:IVFADCIndex.ENC_CHUNK])      # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.build(base_dev)
    torch.cuda.synchronize()
    res["build_codes_per_s"] = N_DB / (time.perf_counter() - t0)
    res["pages"] = idx._pg_dec8_t.shape[1] // idx._pg_lp
    res["rows_padded"] = idx._pg_dec8_t.shape[1]
    res["tail_len"] = idx.tail_len
    res["bucket_cap"] = idx._buckets.shape[1]

    n = idx.ntotal
    V.ivf_pages_segmin.launches = 0
    for nprobe in IVF_NPROBES:
        d, i, dropped = ivf_batches(
            idx, q_dev, lambda x, q: fast_batch(x, q, nprobe))
        check_ids(d, i, n, f"search_fast nprobe {nprobe}")
        res[f"recall_at_10_fast_{nprobe}"] = recall_at_k(i, gt, k=10)
        res[f"recall_at_1_fast_{nprobe}"] = recall_at_k(i, gt, k=1)
        res[f"n_dropped_{nprobe}"] = int(dropped.sum())
    d, i = ivf_batches(idx, q_dev, lambda x, q: x.search(
        q, K, nprobe=IVF_REF_NPROBE))
    torch.cuda.synchronize()
    res["launches"] = V.ivf_pages_segmin.launches
    check_ids(d, i, n, "search")
    res["recall_at_10_ref"] = recall_at_k(i, gt, k=10)
    res["recall_at_1_ref"] = recall_at_k(i, gt, k=1)
    res["parity_pt"] = 100 * (res["recall_at_10_ref"]
                              - res[f"recall_at_10_fast_{IVF_REF_NPROBE}"])
    assert res["launches"] > 0, "the ivf_page kernel never launched"
    for nprobe in IVF_NPROBES:
        assert res[f"n_dropped_{nprobe}"] == 0, nprobe
    assert abs(res["parity_pt"]) <= 1.0, res["parity_pt"]
    res["_index"] = idx
    return res


def main_path_ivf_args(idx, q_dev):
    """The ivf_page kernel's arguments in one nprobe-16 search_fast batch,
    recorded where the wrapper validates them before its launch."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    seen = []
    check = V._check_launch

    def record(*args):
        seen.append(args)
        check(*args)
    V._check_launch = record
    try:
        idx.search_fast(q_dev[:IVF_B], K, nprobe=IVF_REF_NPROBE)
    finally:
        V._check_launch = check
    return list(seen[0])


def phase_ivf_timing(idx, q_dev, args, reps: int) -> dict:
    """Step 7's CUDA-event times at the IVF path's shapes."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    q = q_dev[:IVF_B]
    out = {f"fast_{p}_ms": cuda_ms(lambda: idx.search_fast(q, K, nprobe=p),
                                   reps) for p in IVF_NPROBES}
    out["ref_ms"] = cuda_ms(lambda: idx.search(q, K, nprobe=IVF_REF_NPROBE),
                            reps)
    out["ivf_page_ms"] = cuda_ms(lambda: V.ivf_pages_segmin(*args), reps)
    out["ivf_page_plain_ms"] = cuda_ms(
        lambda: V.ivf_pages_segmin_plain(*args), 2)
    return out


def print_compare(what: str, cmp: dict, stamp: str) -> None:
    for name, c in cmp.items():
        print(f"kernel vs twin, {what}: {name} max|diff| {c['max_abs_err']}"
              f", {c['rows_differ']} rows differ, {c['near_half_rows']} "
              f"rows within 1e-4 of a half-integer {stamp}")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing was run")
    from cvt_tpu_torch.ops.kernels import _build

    card = card_line()
    print(card)
    stamp = f"({card})"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")

    stale = _build.library_path()
    if os.path.exists(stale):
        os.unlink(stale)                     # build from the sources, now
    t0 = time.perf_counter()
    _build.load()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s {stamp}")
    with open(stale[:-3] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  " + line.strip())

    print_compare("random codes, Npad=65536 B=1024",
                  compare_both(*random_kernel_args(65_536, 1024,
                                                   65_536 - 1000)), stamp)

    ivf_rand = compare_ivf_kernel(random_ivf_args(D, 200))
    print(f"kernel vs twin, random inputs, S=48 pages B=200 (Bpad 256): "
          f"ivf_page max|diff| {ivf_rand['max_abs_err']} {stamp}")

    res = phase_main_path()
    idx, q_dev = res.pop("_index"), res.pop("_q")
    base_dev, gt = res.pop("_base"), res.pop("_gt")
    print(f"main path: data {res['data_s']:.1f} s, OPQ train "
          f"{res['opq_train_s']:.1f} s {stamp}")
    print(f"encode: {res['encode_codes_per_s']:.0f} codes/s {stamp}")
    for name in ("fast", "exact", "reference"):
        print(f"recall@1 {name}: {res[f'recall_at_1_{name}']:.4f}  "
              f"recall@10 {name}: {res[f'recall_at_10_{name}']:.4f} {stamp}")
    print(f"parity (reference - fast recall@1): {res['parity_pt']:.2f} pt "
          f"(target 0.5, limit 1.0) {stamp}")
    print(f"decoded cache vs fast: top-1 equal {res['cached_top1_equal']}, "
          f"all ids equal {res['cached_all_ids_equal_frac']:.6f}, at the "
          f"fast path's tile {res['cached_same_tile_ids_equal']} {stamp}")
    print(f"launches during the main path: {res['launches']} {stamp}")

    dec_args, cached_args = main_path_kernel_args(idx, q_dev)
    cmp = compare_both(dec_args, cached_args, idx._norm_col[:, 0])
    npad = dec_args[2].shape[0]
    print_compare(f"main path's arguments, Npad={npad} B={N_QUERIES} "
                  f"tiles {dec_args[-1]}/{cached_args[-1]}", cmp, stamp)

    tm = phase_timing(idx, q_dev, dec_args, cached_args, reps=5)
    for name in ("fast", "exact", "cached"):
        ms = tm[f"{name}_ms"]
        print(f"search {name} 1M x 8192, k=10: {ms:.3f} ms/batch, "
              f"{N_QUERIES / ms * 1e3:.0f} QPS {stamp}")
    for name in ("adc_segmin", "adc_segmin_cached"):
        print(f"{name} 1M x 8192: kernel {tm[name + '_ms']:.3f} ms, twin "
              f"{tm[name + '_plain_ms']:.3f} ms {stamp}")

    iv = phase_ivf(base_dev, q_dev, gt)
    ivf_idx = iv.pop("_index")
    print(f"IVF-ADC {IVF_KC} cells, m={IVF_M}, K={KSUB}: train "
          f"{iv['train_s']:.1f} s, build {iv['build_codes_per_s']:.0f} "
          f"codes/s, {iv['pages']} pages ({iv['rows_padded']} padded "
          f"rows), bucket cap {iv['bucket_cap']}, tail {iv['tail_len']} "
          f"{stamp}")
    for p in IVF_NPROBES:
        print(f"IVF search_fast nprobe {p}: recall@1 "
              f"{iv[f'recall_at_1_fast_{p}']:.4f} recall@10 "
              f"{iv[f'recall_at_10_fast_{p}']:.4f}, dropped pages "
              f"{iv[f'n_dropped_{p}']} {stamp}")
    print(f"IVF search (reference engine) nprobe {IVF_REF_NPROBE}: recall@1 "
          f"{iv['recall_at_1_ref']:.4f} recall@10 "
          f"{iv['recall_at_10_ref']:.4f}; parity (reference - fast "
          f"recall@10) {iv['parity_pt']:.2f} pt (limit 1.0), tail "
          f"{iv['tail_len']} entries scanned by every reference query "
          f"{stamp}")
    print(f"launches during the IVF path: ivf_page {iv['launches']} {stamp}")
    ivf_args = main_path_ivf_args(ivf_idx, q_dev)
    ivf_cmp = compare_ivf_kernel(ivf_args)
    print(f"kernel vs twin, IVF main path's arguments (nprobe "
          f"{IVF_REF_NPROBE}, B={IVF_B}, segpack {ivf_cmp['shape']}): "
          f"ivf_page max|diff| {ivf_cmp['max_abs_err']} {stamp}")
    itm = phase_ivf_timing(ivf_idx, q_dev, ivf_args, reps=10)
    for p in IVF_NPROBES:
        ms = itm[f"fast_{p}_ms"]
        print(f"IVF search_fast 1M, B={IVF_B}, nprobe {p}: {ms:.3f} "
              f"ms/batch, {IVF_B / ms * 1e3:.0f} QPS {stamp}")
    print(f"IVF search (reference engine) nprobe {IVF_REF_NPROBE}: "
          f"{itm['ref_ms']:.3f} ms/batch {stamp}")
    print(f"ivf_page at the nprobe-{IVF_REF_NPROBE} batch: kernel "
          f"{itm['ivf_page_ms']:.3f} ms, twin {itm['ivf_page_plain_ms']:.3f}"
          f" ms {stamp}")

    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SRC,
         "replaces": f"cvt_tpu/ops/pallas/adc_scan.py:{line}",
         "launches": res["launches"][name],
         "max_abs_err": cmp[name]["max_abs_err"], "ms": tm[name + "_ms"],
         "plain_ms": tm[name + "_plain_ms"]}
        for name, line in (("adc_segmin", 76), ("adc_segmin_cached", 448))]
    kernels.append({
        "name": "ivf_page", "route": "cuda", "source": IVF_SRC,
        "replaces": "cvt_tpu/ops/pallas/ivf_scan.py:82",
        "launches": iv["launches"], "max_abs_err": ivf_cmp["max_abs_err"],
        "ms": itm["ivf_page_ms"], "plain_ms": itm["ivf_page_plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
