"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root

1. Card and kernels: refuses to run without CUDA; prints the card's name
   and power limit (nvidia-smi); pins float32 matrix products to full
   precision; builds the CUDA kernels from csrc/ (timed) and prints each
   kernel's registers and spills (ptxas) and, where the toolkit has
   cuobjdump, the count of each scoring instruction class in its SASS
   (IMMA / IGMMA: int8 tensor cores; IDP4A: dp4a on the CUDA cores);
   `ivf_page` must show IGMMA and no IDP4A.
2. Kernel against twin on seeded random inputs: both ADC kernels and
   their plain PyTorch twins (Npad = 65,536, B = 1,024, D = 128, M = 8,
   K = 256), then the decode kernel at every smaller segment size
   (64 / 32 / 16 / 8, tiles 1,024 and 256, the last tile partly valid).
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
   (pad rows, masked segments, Bpad > B), every slot live and with the
   last 4 of 48 slots fill slots (n_live 44); IVFADCIndex.train on 262,144
   vectors (10 + 10 iterations) -> build (codes/s) -> search_fast at
   B = 256, k = 10, nprobe 8 / 16 / 64 over 2,048 queries -> the reference
   engine search() at nprobe 16. Asserts: the kernel launched, no page
   dropped, ids in [0, n) or -1 without duplicates, finite distances,
   |recall@10(search_fast) - recall@10(search)| <= 1.0 point at nprobe 16.
   Then the kernel against its twin on one nprobe-16 batch's own
   arguments (n_live as search_fast passes it), and times (CUDA events)
   of search_fast, search() and the kernel beside its twin; the kernel
   also on one batch's arguments at nprobe 8 and 64, each with its live
   slot count.
8. The int8 SQ lane (BASELINE config 1) on the same base and queries,
   L2-normalised: exact ground truth (FlatIndex, 2,048 queries) ->
   ScalarQuantizer.train / encode on the card (codes/s) ->
   FlatSQIndex.add -> search in bf16 and int8 modes and search_fast at
   B = 8,192, k = 10. Asserts: the cached kernel launched, ids in [0, n),
   finite distances, |recall@10(search_fast) - recall@10(bf16)| <= 1.0
   point. Then the cached kernel against its twin at the path's own
   arguments (Npad 1,000,448, tile 1,024), and times of each mode.
9. The serving front end (BASELINE config 5) on one card: a 1-rank NCCL
   group (init_distributed) and a 'db' mesh of 1; MultiHostADCServer
   over the flat phase's OPQ and 1M codes with the allgather and the ring
   merge serves 2,048 queries at B = 1,024, k = 10; serve_pipelined
   [2, 1,024] and ShardedADCSearcher(impl="kernel") must give serve's
   ids; QueryBatcher answers 8 threads' blocks of 1 / 37 / 256 / 500
   rows; |recall@1(serve) - recall@1(reference engine)| <= 1.0 point.
   Then the `adc_segmin` kernel against its twin at the server's own
   arguments, sharded_kmeans_step against one `_lloyd` step, and
   `python -m cvt_tpu_torch.cli serve` as a subprocess on a saved pack
   (batch mode and --stdin), whose ids must equal the in-process serve.
   Times of serve with each merge and of serve_pipelined.
10. The split of each ADC call at the flat path's shape into its scan
   kernel and `tiletop_kernel` (torch.profiler device time; last, since
   the profiler's hooks slow the host side of what runs after it).
   Each kernel's bound at each path's shape: the larger of the bytes it
   must move (each input read once, each output written once) over 3.35
   TB/s and its int8 operations (2 per multiply-add; IVF: the n_live live
   page slots only) over 1,979 TOP/s, the H100 SXM data sheet's rates;
   and its time's share of that bound. One JSON line describing the three
   kernels (launches summed over the paths that run each, max_abs_err the
   worst of its comparisons, ms / bound at the flat path's shape for the
   ADC kernels and at the nprobe-16 batch for `ivf_page`, every path under
   by_path, `ivf_page` at each nprobe under by_nprobe with its live slot
   count; no one PyTorch call computes packed segment minima, so
   library_ms is null) and, last, the device line.

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
import re
import shutil
import subprocess
import sys
import time

import numpy as np
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
SEG_VARIANTS = (64, 32, 16, 8)
# the serving front end (BASELINE config 5) on one card
SERVE_B, KM_N, KM_K, CLI_STDIN_ROWS = 1024, 65_536, 256, 4
BATCHER_BLOCKS = (1, 37, 256, 500)
# H100 SXM data sheet: dense int8 tensor-core rate, HBM3 bandwidth
PEAK_INT8_OPS, HBM_BYTES_PER_S = 1.979e15, 3.35e12
SASS_CLASSES = ("IMMA", "IGMMA", "IDP4A")


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


def bound(ops: float, nbytes: float) -> dict:
    """The least time for the work: bytes over the memory rate or int8
    operations over the int8 peak, whichever is larger, and which."""
    t_ops = ops / PEAK_INT8_OPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def adc_bound(args, cached: bool) -> dict:
    """Bound of one `adc_segmin` (cached=False) or `adc_segmin_cached`
    call on its arguments: every padded row against every padded query,
    the inputs read once, segpack and tiletop written once."""
    q2s = args[0]
    bpad, d = q2s.shape
    n_in = 4 if cached else 5
    npad = args[2].shape[1] if cached else args[2].shape[0]
    tile_n = args[n_in + 1]
    seg = args[n_in + 2] if len(args) > n_in + 2 else 128
    out = 4 * bpad * (npad // seg + 8 * (npad // tile_n))
    return bound(2.0 * npad * d * bpad, nbytes(*args[:n_in]) + out)


def live_slots(args) -> int:
    """The live page slots of an `ivf_page` call: its n_live argument
    (capped at sel's length), or every slot where it has none."""
    n_slots = args[5].shape[0]
    if len(args) < 9 or args[8] is None:
        return n_slots
    return min(int(args[8]), n_slots)


def ivf_bound(args) -> dict:
    """Bound of one `ivf_page` call, counting the live page slots only:
    their cache rows and norms, coarse terms and minima, plus the
    queries. The kernel skips the fill slots past n_live."""
    q2s, _, dec8_t, _, _, sel, lp, seg = args[:8]
    bpad, d = q2s.shape
    n_live = live_slots(args)
    mins = n_live * (lp // seg) * bpad * 4
    return bound(2.0 * n_live * lp * d * bpad,
                 n_live * lp * (d + 4) + 2 * mins + nbytes(q2s, sel))


def share(ms: float, b: dict) -> dict:
    return dict(b, ms=ms, bound_share=b["bound_ms"] / ms)


def print_bound(name: str, shape: str, r: dict, stamp: str) -> None:
    print(f"{name} at {shape}: {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} "
          f"ms ({r['bound_by']}: {r['ops']:.3e} int8 ops, "
          f"{r['bytes'] / 1e6:.1f} MB), {r['bound_share']:.1%} of the "
          f"bound {stamp}")


def kernel_split(fn, reps: int) -> dict:
    """Device ms per call of the scan kernel and of tiletop_kernel in one
    ADC wrapper call (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {"scan_ms": 0.0, "tiletop_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        key = "tiletop_ms" if "tiletop_kernel" in e.key else (
            "scan_ms" if "adc_segmin" in e.key else None)
        if key:
            out[key] += e.self_device_time_total / 1e3 / reps
    if not out["scan_ms"]:
        raise RuntimeError("the profiler recorded no ADC scan kernel")
    return out


def kernel_name(mangled: str) -> str | None:
    """'adc_segmin_kernel<128>' from a mangled kernel name, else None."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)E)?", mangled)
    if m is None:
        return None
    return m.group(1) + (f"<{m.group(2)}>" if m.group(2) else "")


def ptxas_report(log: str) -> dict:
    """{kernel: 'N registers, spill stores/loads'} from the build log,
    with any ptxas performance warning about the kernel appended."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        regs = re.search(r"Used (\d+) registers", line)
        if m:
            name = kernel_name(m.group(1))
        elif "Performance Loss" in line:
            fn = re.search(r"function '(\S+)'", line)
            key = kernel_name(fn.group(1)) if fn else name
            out[key] = f"{out.get(key, '')}; {line.strip()}"
        elif name and "spill" in line:
            out[name] = line.strip()
        elif name and regs:
            out[name] = f"{regs.group(1)} registers, {out.get(name, '')}"
    return out


def sass_classes(lib: str) -> dict:
    """{kernel: {class: count}} of the scoring instruction classes in the
    library's SASS, or {} where the toolkit has no cuobjdump."""
    from cvt_tpu_torch.ops.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        return {}
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            if name:
                out[name] = dict.fromkeys(SASS_CLASSES, 0)
            continue
        op = re.search(r"\b(IMMA|IGMMA|IDP\.?4A)\b", line)
        if name and op:                     # dp4a is IDP.4A in SASS
            out[name][op.group(1).replace(".", "")] += 1
    return out


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


def compare_kernel_to_twin(kernel, twin, args, norm, qs, tile_n,
                           seg: int = 128) -> dict:
    """Run a kernel and its twin on the same arguments. Differences are
    allowed only in segments (and tiles) holding a row whose norm/qs lies
    within 1e-4 of a half-integer, and a segment minimum may move by at
    most seg; anything else raises."""
    r = norm.double() / float(qs)
    near_half = torch.nonzero((r - torch.floor(r) - 0.5).abs() < 1e-4)[:, 0]
    got = kernel(*args)
    want = twin(*args)
    max_err, n_diff = 0, 0
    for a, b, rows in zip(got, want, (seg, tile_n)):
        allowed = torch.zeros(a.shape[0], dtype=torch.bool, device=a.device)
        allowed[near_half // rows] = True
        diff = (a.long() - b.long()).abs()
        bad = diff.flatten(1).amax(1) > 0
        n_diff += int(bad.sum())
        if bool((bad & ~allowed).any()):
            raise AssertionError(f"{kernel.__name__}: kernel differs from "
                                 f"its twin outside near-half rows")
        max_err = max(max_err, int(diff.max()))
    if int((got[0].long() - want[0].long()).abs().max()) > seg:
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


def compare_seg_variants(dec_args, dec_norm) -> dict:
    """The decode kernel against its twin at each segment size below 128
    (the sharded searcher and the server halve it on small shards), at
    tiles 1,024 and 256, on random arguments whose last tile is partly
    valid. Per seg, the worst of the two tiles."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    out = {}
    for seg in SEG_VARIANTS:
        cmps = [compare_kernel_to_twin(
            T.adc_segmin, T.adc_segmin_plain, dec_args[:6] + (tile_n, seg),
            dec_norm, dec_args[1], tile_n, seg) for tile_n in (1024, 256)]
        out[seg] = {key: max(c[key] for c in cmps) for key in cmps[0]}
    return out


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
    res["_ids_ref"] = ids_ref
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
    out["adc_segmin_ms"] = cuda_ms(lambda: T.adc_segmin(*dec_args),
                                   2 * reps)
    out["adc_segmin_plain_ms"] = cuda_ms(
        lambda: T.adc_segmin_plain(*dec_args), 1)
    out["adc_segmin_cached_ms"] = cuda_ms(
        lambda: T.adc_segmin_cached(*cached_args), 2 * reps)
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


def main_path_ivf_args(idx, q_dev, nprobe: int = IVF_REF_NPROBE):
    """The ivf_page kernel's arguments (n_live included) in one search_fast
    batch at nprobe, recorded where the wrapper validates them before its
    launch."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    seen = []
    check = V._check_launch

    def record(*args):
        seen.append(args)
        check(*args)
    V._check_launch = record
    try:
        idx.search_fast(q_dev[:IVF_B], K, nprobe=nprobe)
    finally:
        V._check_launch = check
    return list(seen[0])


def phase_ivf_timing(idx, q_dev, args_by_nprobe, reps: int) -> dict:
    """Step 7's CUDA-event times at the IVF path's shapes: search_fast and
    the kernel at each nprobe, search() and the twin at nprobe 16."""
    from cvt_tpu_torch.ops.kernels import ivf_scan as V
    q = q_dev[:IVF_B]
    out = {f"fast_{p}_ms": cuda_ms(lambda: idx.search_fast(q, K, nprobe=p),
                                   reps) for p in IVF_NPROBES}
    out["ref_ms"] = cuda_ms(lambda: idx.search(q, K, nprobe=IVF_REF_NPROBE),
                            reps)
    for p, args in args_by_nprobe.items():
        out[f"ivf_page_{p}_ms"] = cuda_ms(
            lambda: V.ivf_pages_segmin(*args), reps)
    out["ivf_page_ms"] = out[f"ivf_page_{IVF_REF_NPROBE}_ms"]
    out["ivf_page_plain_ms"] = cuda_ms(lambda: V.ivf_pages_segmin_plain(
        *args_by_nprobe[IVF_REF_NPROBE]), 2)
    return out


def phase_sq(base_dev, q_dev) -> dict:
    """Step 8's main path (BASELINE config 1): the L2-normalised base and
    queries, exact ground truth, ScalarQuantizer train / encode on the
    card, FlatSQIndex search in bf16 and int8 modes and search_fast (the
    decoded-cache kernel), all at B = 8,192, k = 10."""
    from cvt_tpu_torch.index import FlatIndex, FlatSQIndex
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.ops.linalg import l2_normalize
    from cvt_tpu_torch.quant import ScalarQuantizer
    from cvt_tpu_torch.utils import recall_at_k
    res = {}
    xb, xq = l2_normalize(base_dev), l2_normalize(q_dev)
    exact_index = FlatIndex(D, "l2", chunk=131_072, device=DEV)
    exact_index.add(xb)
    gt = torch.cat([exact_index.search(xq[s:min(s + 512, N_REC)], 1)[1]
                    for s in range(0, N_REC, 512)])[:, 0].cpu()
    del exact_index

    T.adc_segmin_cached.launches = 0
    t0 = time.perf_counter()
    sq = ScalarQuantizer.train(xb)
    torch.cuda.synchronize()
    res["train_s"] = time.perf_counter() - t0
    sq.encode(xb[:65_536])                                    # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    codes = sq.encode(xb)
    torch.cuda.synchronize()
    res["encode_codes_per_s"] = N_DB / (time.perf_counter() - t0)
    idx = {}
    for mode in ("bf16", "int8"):
        idx[mode] = FlatSQIndex(sq, mode=mode)
        idx[mode].add(codes=codes)
    out = {mode: idx[mode].search(xq, K) for mode in idx}
    out["fast"] = idx["bf16"].search_fast(xq, K)
    torch.cuda.synchronize()
    res["launches"] = T.adc_segmin_cached.launches

    n = idx["bf16"].ntotal
    for name, (d, i) in out.items():
        assert i.shape == (N_QUERIES, K), name
        assert int(i.min()) >= 0 and int(i.max()) < n, name
        assert bool(torch.isfinite(d).all()), name
        res[f"recall_at_1_{name}"] = recall_at_k(i[:N_REC], gt, k=1)
        res[f"recall_at_10_{name}"] = recall_at_k(i[:N_REC], gt, k=10)
    res["parity_pt"] = 100 * (res["recall_at_10_bf16"]
                              - res["recall_at_10_fast"])
    assert res["launches"] > 0, "the cached kernel never launched"
    assert abs(res["parity_pt"]) <= 1.0, res["parity_pt"]
    res["_index"], res["_xq"] = idx, xq
    return res


def sq_kernel_args(idx, xq):
    """The cached kernel's arguments in FlatSQIndex.search_fast: the
    bias-folded queries, the index's cache and norm column, its tile."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    sq = idx.sq
    q = xq - (sq.bias + 128.0 * sq.scale)[None, :]
    vcap, _ = T._pack_caps(T.SEG, D)
    q2s, qs = T._fold_queries(q, sq.scale, torch.amax(idx._norm_col), vcap)
    return (q2s, qs, idx._dec8_t, idx._norm_col, idx.ntotal,
            T.cached_tile_n(idx._dec8_t.shape[1]))


def phase_sq_timing(idx, xq, args, reps: int) -> dict:
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    out = {f"{mode}_ms": cuda_ms(lambda: idx[mode].search(xq, K), 2)
           for mode in ("bf16", "int8")}
    out["fast_ms"] = cuda_ms(lambda: idx["bf16"].search_fast(xq, K), reps)
    out["kernel_ms"] = cuda_ms(lambda: T.adc_segmin_cached(*args),
                               2 * reps)
    out["plain_ms"] = cuda_ms(lambda: T.adc_segmin_cached_plain(*args), 1)
    return out


def batched(fn, q, b: int):
    """fn(batch, K) over q in batches of b -> (dists, ids) concatenated."""
    outs = [fn(q[s:s + b], K) for s in range(0, q.shape[0], b)]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def run_batcher(srv, q_host) -> dict:
    """QueryBatcher over srv.serve: 8 threads submit blocks of 1, 37, 256
    and 500 rows at once; every future must resolve to [rows, k] results
    with ids in [0, n)."""
    import threading
    from cvt_tpu_torch.parallel import QueryBatcher
    batcher = QueryBatcher(srv.serve, batch_size=SERVE_B, k=K,
                           max_wait_ms=5.0)
    futs, lock = [], threading.Lock()

    def submit(t: int):
        rows = BATCHER_BLOCKS[t % len(BATCHER_BLOCKS)]
        f = batcher.submit(q_host[t * 200:t * 200 + rows])
        with lock:
            futs.append((rows, f))
    threads = [threading.Thread(target=submit, args=(t,)) for t in range(8)]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        done = [(rows, f.result(timeout=120)) for rows, f in futs]
    finally:
        batcher.close()
    wall = time.perf_counter() - t0
    for rows, (d, i) in done:
        assert d.shape == (rows, K) and i.shape == (rows, K), rows
        assert (i >= 0).all() and (i < srv._n).all(), rows
        assert np.isfinite(d).all(), rows
    return {"futures": len(done), "rows": sum(r for r, _ in done),
            "wall_s": wall}


def run_cli(idx, q_host, tmp: str) -> dict:
    """`python -m cvt_tpu_torch.cli serve` as a subprocess on a saved pack:
    batch mode over the first N_REC queries (fvecs) and --stdin mode over
    CLI_STDIN_ROWS JSON lines. Returns each mode's ids and wall time."""
    from cvt_tpu_torch.io.vecs import write_fvecs
    pack, qf = os.path.join(tmp, "pack.npz"), os.path.join(tmp, "q.fvecs")
    idx.save(pack)
    write_fvecs(qf, q_host[:N_REC])
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "cvt_tpu_torch.cli", "serve", "--index",
           pack, "--k", str(K), "--batch", str(SERVE_B)]
    stdin = "".join(json.dumps(row.tolist()) + "\n"
                    for row in q_host[:CLI_STDIN_ROWS])
    out = {}
    for mode, extra, text in (("batch", ["--queries", qf], None),
                              ("stdin", ["--stdin"], stdin)):
        t0 = time.perf_counter()
        run = subprocess.run(cmd + extra, input=text, capture_output=True,
                             text=True, cwd=root, timeout=300)
        if run.returncode:
            raise RuntimeError(f"cli serve ({mode}) exited "
                               f"{run.returncode}: {run.stderr[-2000:]}")
        out[f"{mode}_s"] = time.perf_counter() - t0
        out[mode] = np.array([json.loads(line)["ids"]
                              for line in run.stdout.splitlines()
                              if line.startswith("{")])
    return out


def phase_serve(flat_idx, q_dev, gt, ids_ref) -> dict:
    """Step 9's main path (BASELINE config 5's front end on one card): a
    1-rank NCCL group and a 'db' mesh of 1; MultiHostADCServer over the
    flat phase's OPQ and 1M codes with both merges, serve_pipelined,
    ShardedADCSearcher(impl='kernel') and QueryBatcher, all through the
    `adc_segmin` kernel."""
    import torch.distributed as dist
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.parallel import (MultiHostADCServer,
                                        ShardedADCSearcher, init_distributed,
                                        serving_mesh)
    from cvt_tpu_torch.quant import OPQ
    from cvt_tpu_torch.utils import recall_at_k
    res = {}
    t0 = time.perf_counter()
    assert init_distributed() == 0
    res["init_s"] = time.perf_counter() - t0
    assert dist.get_backend() == "nccl" and dist.get_world_size() == 1
    mesh = serving_mesh()
    assert mesh.device_type == "cuda"
    opq = OPQ(flat_idx.rotation, flat_idx.pq)
    codes = flat_idx._codes
    q = q_dev[:N_REC]

    T.adc_segmin.launches = 0
    srv, got = {}, {}
    for merge in ("allgather", "ring"):
        srv[merge] = MultiHostADCServer(opq, mesh, merge=merge)
        srv[merge].load(codes=codes)
        got[merge] = batched(srv[merge].serve, q, SERVE_B)
    pipe = srv["ring"].serve_pipelined(q.reshape(-1, SERVE_B, D), K)
    searcher = ShardedADCSearcher(opq, mesh, impl="kernel")
    searcher.load(codes=codes)
    got["searcher"] = batched(searcher.search, q, SERVE_B)
    res["batcher"] = run_batcher(srv["allgather"], q.cpu().numpy())
    torch.cuda.synchronize()
    res["launches"] = T.adc_segmin.launches

    ids = got["allgather"][1]
    n = srv["allgather"]._n
    assert ids.shape == (N_REC, K)
    assert int(ids.min()) >= 0 and int(ids.max()) < n
    assert bool(torch.isfinite(got["allgather"][0]).all())
    for name in ("ring", "searcher"):
        res[f"{name}_ids_equal"] = bool(torch.equal(got[name][1], ids))
    res["pipelined_ids_equal"] = bool(torch.equal(pipe[1], got["ring"][1]))
    res["pipelined_dists_equal"] = bool(torch.equal(pipe[0],
                                                    got["ring"][0]))
    res["recall_at_1_serve"] = recall_at_k(ids, gt, k=1)
    res["recall_at_10_serve"] = recall_at_k(ids, gt, k=10)
    res["recall_at_1_ref"] = recall_at_k(ids_ref, gt, k=1)
    res["parity_pt"] = 100 * (res["recall_at_1_ref"]
                              - res["recall_at_1_serve"])
    assert res["launches"] > 0, "the adc_segmin kernel never launched"
    for key in ("ring_ids_equal", "searcher_ids_equal",
                "pipelined_ids_equal", "pipelined_dists_equal"):
        assert res[key], key
    assert abs(res["parity_pt"]) <= 1.0, res["parity_pt"]
    res["_servers"], res["_ids"] = srv, ids.cpu().numpy()
    return res


def serve_kernel_args(srv, q):
    """The `adc_segmin` arguments of srv.serve on one batch q (1 shard):
    its rotated and folded queries, its shard, tile and segment."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    from cvt_tpu_torch.parallel.sharded_search import _segment_plan
    tile_n, seg = _segment_plan(srv._per, srv.tile_n, srv.seg, K)
    q2s, qs = T._fold_queries(srv._rotate(q), srv._srow)
    s2 = srv._srow * srv._srow
    args = (q2s, qs, srv._codes_l, srv._cb_q, s2, min(srv._n, srv._per),
            tile_n, seg)
    norm = T._row_norms(T.decode_int8(srv._codes_l, srv._cb_q), s2)
    return args, norm


def phase_kmeans(base_dev) -> dict:
    """sharded_kmeans_step over a 'dp' mesh of 1 (NCCL all_reduce) against
    one step of the port's _lloyd on the same points and centroids; numpy
    input lands on the mesh's card."""
    from cvt_tpu_torch.ops.kmeans import _lloyd, kmeans_assign
    from cvt_tpu_torch.parallel import make_mesh, sharded_kmeans_step
    x = base_dev[:KM_N]
    c0 = x[:KM_K].clone()
    mesh = make_mesh({"dp": 1})
    c, obj = sharded_kmeans_step(mesh, x, c0)
    cn, _ = sharded_kmeans_step(mesh, x.cpu().numpy(), c0.cpu().numpy())
    assert cn.device == x.device, cn.device
    assert torch.allclose(cn, c, rtol=1e-5, atol=1e-4)
    want, _, _ = _lloyd(x, c0, KM_K, 1, None)
    _, d0 = kmeans_assign(x, c0)
    err = float((c - want).abs().max())
    obj_rel = abs(float(obj) - float(d0.mean())) / float(d0.mean())
    assert torch.allclose(c, want, rtol=1e-5, atol=1e-4), err
    assert obj_rel <= 1e-5, obj_rel
    return {"max_abs_err": err, "objective_rel_err": obj_rel}


def print_compare(what: str, cmp: dict, stamp: str) -> None:
    for name, c in cmp.items():
        print(f"kernel vs twin, {what}: {name} max|diff| {c['max_abs_err']}"
              f", {c['rows_differ']} rows differ, {c['near_half_rows']} "
              f"rows within 1e-4 of a half-integer {stamp}")


def run_sq(base_dev, q_dev, stamp: str) -> dict:
    """Step 8: the SQ phase, its kernel-against-twin check and times."""
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    sq = phase_sq(base_dev, q_dev)
    idx, xq = sq.pop("_index"), sq.pop("_xq")
    print(f"SQ (config 1, 1M x 128 L2-normalised): train {sq['train_s']:.3f}"
          f" s, encode {sq['encode_codes_per_s']:.0f} codes/s {stamp}")
    for name in ("bf16", "int8", "fast"):
        print(f"SQ search {name}: recall@1 {sq[f'recall_at_1_{name}']:.4f} "
              f"recall@10 {sq[f'recall_at_10_{name}']:.4f} {stamp}")
    print(f"SQ parity (bf16 - search_fast recall@10): {sq['parity_pt']:.2f}"
          f" pt (limit 1.0); launches during the SQ path: "
          f"adc_segmin_cached {sq['launches']} {stamp}")
    args = sq_kernel_args(idx["bf16"], xq)
    sq["cmp"] = compare_kernel_to_twin(
        T.adc_segmin_cached, T.adc_segmin_cached_plain, args,
        args[3][:, 0], args[1], args[-1])
    print_compare(f"SQ path's arguments, Npad={args[2].shape[1]} "
                  f"B={N_QUERIES} tile {args[-1]}",
                  {"adc_segmin_cached": sq["cmp"]}, stamp)
    stm = phase_sq_timing(idx, xq, args, reps=5)
    for name in ("bf16", "int8", "fast"):
        ms = stm[f"{name}_ms"]
        print(f"SQ search {name} 1M x 8192, k=10: {ms:.3f} ms/batch, "
              f"{N_QUERIES / ms * 1e3:.0f} QPS {stamp}")
    print(f"adc_segmin_cached at the SQ path: kernel {stm['kernel_ms']:.3f}"
          f" ms, twin {stm['plain_ms']:.3f} ms {stamp}")
    sq["bound"] = share(stm["kernel_ms"], adc_bound(args, cached=True))
    print_bound("adc_segmin_cached", f"the SQ path (Npad "
                f"{args[2].shape[1]}, Bpad {args[0].shape[0]}, tile "
                f"{args[-1]})", sq["bound"], stamp)
    return sq


def run_serving(flat_idx, q_dev, gt, ids_ref, base_dev, stamp: str) -> dict:
    """Step 9: the serving phase, its kernel-against-twin check, sharded
    k-means, the CLI and times; ends the process group."""
    import tempfile
    import torch.distributed as dist
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    sv = phase_serve(flat_idx, q_dev, gt, ids_ref)
    srv, ids = sv.pop("_servers"), sv.pop("_ids")
    print(f"serving: 1-rank NCCL group up in {sv['init_s']:.2f} s; ring, "
          f"ShardedADCSearcher and serve_pipelined ids equal serve's: "
          f"{sv['ring_ids_equal']}, {sv['searcher_ids_equal']}, "
          f"{sv['pipelined_ids_equal']} {stamp}")
    print(f"serve recall@1 {sv['recall_at_1_serve']:.4f} recall@10 "
          f"{sv['recall_at_10_serve']:.4f}; reference engine recall@1 "
          f"{sv['recall_at_1_ref']:.4f}; parity {sv['parity_pt']:.2f} pt "
          f"(limit 1.0) {stamp}")
    b = sv["batcher"]
    print(f"QueryBatcher: {b['futures']} futures from 8 threads "
          f"({b['rows']} rows) resolved in {b['wall_s']:.3f} s {stamp}")
    print(f"launches during the serving path: adc_segmin {sv['launches']} "
          f"{stamp}")
    args, norm = serve_kernel_args(srv["allgather"], q_dev[:SERVE_B])
    sv["cmp"] = compare_kernel_to_twin(T.adc_segmin, T.adc_segmin_plain,
                                       args, norm, args[1], args[-2],
                                       args[-1])
    print_compare(f"server's arguments, Npad={args[2].shape[0]} "
                  f"B={SERVE_B} tile {args[-2]} seg {args[-1]}",
                  {"adc_segmin": sv["cmp"]}, stamp)
    sv["bound"] = share(cuda_ms(lambda: T.adc_segmin(*args), 20),
                        adc_bound(args, cached=False))
    print_bound("adc_segmin", f"the server's batch (Npad "
                f"{args[2].shape[0]}, Bpad {args[0].shape[0]}, tile "
                f"{args[-2]}, seg {args[-1]})", sv["bound"], stamp)
    km = phase_kmeans(base_dev)
    print(f"sharded_kmeans_step ('dp' mesh of 1, {KM_N} x {D}, K {KM_K}) "
          f"vs _lloyd: max|diff| {km['max_abs_err']:.3g}, objective rel "
          f"{km['objective_rel_err']:.3g} {stamp}")
    with tempfile.TemporaryDirectory() as tmp:
        cli = run_cli(flat_idx, q_dev.cpu().numpy(), tmp)
    stdin_want = np.concatenate([
        srv["allgather"].serve(q_dev[j:j + 1], K)[1].cpu().numpy()
        for j in range(CLI_STDIN_ROWS)])
    assert np.array_equal(cli["batch"], ids), "cli batch ids != serve"
    assert np.array_equal(cli["stdin"], stdin_want), "cli stdin ids != serve"
    print(f"cli serve: batch mode {cli['batch'].shape[0]} rows in "
          f"{cli['batch_s']:.1f} s, --stdin {cli['stdin'].shape[0]} rows in "
          f"{cli['stdin_s']:.1f} s (process wall clock); ids equal "
          f"in-process serve {stamp}")
    q = q_dev[:N_REC]
    for merge in ("allgather", "ring"):
        ms = cuda_ms(lambda: srv[merge].serve(q[:SERVE_B], K), 10)
        print(f"serve ({merge}) 1M, B={SERVE_B}, k=10: {ms:.3f} ms/batch, "
              f"{SERVE_B / ms * 1e3:.0f} QPS {stamp}")
    ms = cuda_ms(lambda: srv["ring"].serve_pipelined(
        q.reshape(-1, SERVE_B, D), K), 5) / (N_REC // SERVE_B)
    print(f"serve_pipelined [{N_REC // SERVE_B}, {SERVE_B}]: {ms:.3f} "
          f"ms/batch, {SERVE_B / ms * 1e3:.0f} QPS {stamp}")
    dist.destroy_process_group()
    return sv


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
        for name, line in ptxas_report(f.read()).items():
            print(f"  ptxas {name}: {line}")
    sass = sass_classes(stale)
    for name, counts in sass.items():
        if "adc_segmin" in name or "ivf_page" in name:
            print(f"  SASS {name}: " + ", ".join(
                f"{c} {n}" for c, n in counts.items()))
        if "ivf_page" in name:
            assert counts["IGMMA"] > 0 and counts["IDP4A"] == 0, name
    if not sass:
        print("  SASS: cuobjdump not found; instruction classes not read")

    rand_dec, rand_cached, rand_norm = random_kernel_args(65_536, 1024,
                                                          65_536 - 1000)
    print_compare("random codes, Npad=65536 B=1024",
                  compare_both(rand_dec, rand_cached, rand_norm), stamp)
    segv = compare_seg_variants(rand_dec, rand_norm)
    for seg, c in segv.items():
        print(f"kernel vs twin, random codes, Npad=65536 B=1024 n_valid "
              f"{65_536 - 1000}, seg {seg} (tiles 1024 and 256): adc_segmin "
              f"max|diff| {c['max_abs_err']}, {c['rows_differ']} rows "
              f"differ, {c['near_half_rows']} rows within 1e-4 of a "
              f"half-integer {stamp}")

    ivf_rand = compare_ivf_kernel(random_ivf_args(D, 200))
    print(f"kernel vs twin, random inputs, S=48 pages B=200 (Bpad 256): "
          f"ivf_page max|diff| {ivf_rand['max_abs_err']} {stamp}")
    ivf_rand_live = compare_ivf_kernel(random_ivf_args(D, 200) + [
        torch.tensor([44], dtype=torch.int32, device=DEV)])
    print(f"kernel vs twin, random inputs, S=48 pages B=200, n_live 44: "
          f"ivf_page max|diff| {ivf_rand_live['max_abs_err']} {stamp}")

    res = phase_main_path()
    idx, q_dev = res.pop("_index"), res.pop("_q")
    base_dev, gt = res.pop("_base"), res.pop("_gt")
    ids_ref = res.pop("_ids_ref")
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
    flat_b = {"adc_segmin": adc_bound(dec_args, cached=False),
              "adc_segmin_cached": adc_bound(cached_args, cached=True)}
    for name in ("adc_segmin", "adc_segmin_cached"):
        print(f"{name} 1M x 8192: kernel {tm[name + '_ms']:.3f} ms, twin "
              f"{tm[name + '_plain_ms']:.3f} ms {stamp}")
        flat_b[name] = share(tm[name + "_ms"], flat_b[name])
        print_bound(name, f"the flat path (Npad {npad}, Bpad {N_QUERIES})",
                    flat_b[name], stamp)

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
    ivf_by_p = {p: main_path_ivf_args(ivf_idx, q_dev, p)
                for p in IVF_NPROBES}
    ivf_args = ivf_by_p[IVF_REF_NPROBE]
    assert ivf_args[8] is not None, "search_fast passed no n_live"
    ivf_cmp = compare_ivf_kernel(ivf_args)
    print(f"kernel vs twin, IVF main path's arguments (nprobe "
          f"{IVF_REF_NPROBE}, B={IVF_B}, segpack {ivf_cmp['shape']}, "
          f"n_live {live_slots(ivf_args)}): ivf_page max|diff| "
          f"{ivf_cmp['max_abs_err']} {stamp}")
    itm = phase_ivf_timing(ivf_idx, q_dev, ivf_by_p, reps=10)
    for p in IVF_NPROBES:
        ms = itm[f"fast_{p}_ms"]
        print(f"IVF search_fast 1M, B={IVF_B}, nprobe {p}: {ms:.3f} "
              f"ms/batch, {IVF_B / ms * 1e3:.0f} QPS {stamp}")
    print(f"IVF search (reference engine) nprobe {IVF_REF_NPROBE}: "
          f"{itm['ref_ms']:.3f} ms/batch {stamp}")
    print(f"ivf_page at the nprobe-{IVF_REF_NPROBE} batch: kernel "
          f"{itm['ivf_page_ms']:.3f} ms, twin {itm['ivf_page_plain_ms']:.3f}"
          f" ms {stamp}")
    ivf_bp = {}
    for p, args in ivf_by_p.items():
        ivf_bp[p] = dict(share(itm[f"ivf_page_{p}_ms"], ivf_bound(args)),
                         live_slots=live_slots(args),
                         slots=args[5].shape[0])
        print_bound("ivf_page", f"the nprobe-{p} batch (B {IVF_B}, "
                    f"{ivf_bp[p]['live_slots']} live of "
                    f"{ivf_bp[p]['slots']} page slots)", ivf_bp[p], stamp)
    ivf_b = ivf_bp[IVF_REF_NPROBE]

    sq = run_sq(base_dev, q_dev, stamp)
    sv = run_serving(idx, q_dev, gt, ids_ref, base_dev, stamp)
    # last: the profiler leaves its hooks behind, which slows the host side
    # of whatever runs after it
    from cvt_tpu_torch.ops.kernels import adc_scan as T
    split = {"adc_segmin": kernel_split(lambda: T.adc_segmin(*dec_args), 5),
             "adc_segmin_cached": kernel_split(
                 lambda: T.adc_segmin_cached(*cached_args), 5)}
    for name, s in split.items():
        print(f"{name} at the flat path, split (profiler, device ms per "
              f"call): scan kernel {s['scan_ms']:.3f}, tiletop_kernel "
              f"{s['tiletop_ms']:.3f} {stamp}")

    seg_err = {str(s): c["max_abs_err"] for s, c in segv.items()}

    def sass_of(name: str) -> dict | None:
        """The scoring classes summed over a kernel's SEG instances, or None
        where no SASS was read (no cuobjdump)."""
        if not sass:
            return None
        return {c: sum(v[c] for k, v in sass.items()
                       if k.startswith(name + "<")) for c in SASS_CLASSES}

    def entry(name, source, replaces, launches, max_err, ms, plain_ms, b,
              **extra):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches,
                    max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                    library_ms=None, bound_share=b["bound_ms"] / ms, **extra)

    def path(b: dict) -> dict:
        return {k: b[k] for k in ("ms", "bound_ms", "bound_by",
                                  "bound_share")}
    kernels = [
        entry("adc_segmin", KERNEL_SRC, "cvt_tpu/ops/pallas/adc_scan.py:76",
              res["launches"]["adc_segmin"] + sv["launches"],
              max(cmp["adc_segmin"]["max_abs_err"],
                  sv["cmp"]["max_abs_err"], *seg_err.values()),
              tm["adc_segmin_ms"], tm["adc_segmin_plain_ms"],
              flat_b["adc_segmin"],
              launches_by_path={"flat": res["launches"]["adc_segmin"],
                                "serve": sv["launches"]},
              seg_variants_max_abs_err=seg_err,
              by_path={"flat": path(flat_b["adc_segmin"]),
                       "serve": path(sv["bound"])},
              split_ms=split["adc_segmin"], sass=sass_of("adc_segmin_kernel")),
        entry("adc_segmin_cached", KERNEL_SRC,
              "cvt_tpu/ops/pallas/adc_scan.py:448",
              res["launches"]["adc_segmin_cached"] + sq["launches"],
              max(cmp["adc_segmin_cached"]["max_abs_err"],
                  sq["cmp"]["max_abs_err"]),
              tm["adc_segmin_cached_ms"], tm["adc_segmin_cached_plain_ms"],
              flat_b["adc_segmin_cached"],
              launches_by_path={"flat": res["launches"]["adc_segmin_cached"],
                                "sq": sq["launches"]},
              by_path={"flat": path(flat_b["adc_segmin_cached"]),
                       "sq": path(sq["bound"])},
              split_ms=split["adc_segmin_cached"],
              sass=sass_of("adc_segmin_cached_kernel")),
        entry("ivf_page", IVF_SRC, "cvt_tpu/ops/pallas/ivf_scan.py:82",
              iv["launches"],
              max(ivf_cmp["max_abs_err"], ivf_rand["max_abs_err"],
                  ivf_rand_live["max_abs_err"]),
              itm["ivf_page_ms"], itm["ivf_page_plain_ms"], ivf_b,
              live_slots=ivf_b["live_slots"], by_path={"ivf": path(ivf_b)},
              by_nprobe={str(p): dict(path(b), live_slots=b["live_slots"])
                         for p, b in ivf_bp.items()},
              sass=sass_of("ivf_page_kernel"))]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
