"""The feature layer at the vlindex operating point (`_bench_features.py`
on the port): the extraction and matching pillar of BASELINE config 3.

    python -m cvt_tpu_torch.benches.features [extract,match,verify]
        [--device cpu]

Operating point (retrieval/vlindex/src/feature/sift.h:44-113): first
octave -1, 3 scales per octave, peak threshold 0.02 / 3, edge threshold
10, 2 orientations, RootSIFT, 640 x 480 procedural images.

  extract  images/s, ms per batch, mean keypoints and peak device memory
           of `extract_sift` at each (B, K) of SWEEP: ITERS batches back
           to back between CUDA events, the median of EXTRACT_WINDOWS
           windows with the fastest and slowest beside it;
  match    `match_descriptors` (ratio 0.9, cross-check) pairs/s at K 8,192
           over 8 images' features, 16 pairs per window cycling (i, i+1);
  verify   two-view verification pairs/s: match, the matched keypoints to
           the host, padded to a BUCKET of 1,024 rows (match_pairs'
           fixed shape), `estimate_two_view_geometry` (RANSAC F / H and
           the configuration), host clock over N_VERIFY pairs.

The script folded each output into the next input to serialise
dispatches on a remote backend; CUDA events need no chain. The time sits
between the events: `extract_sift` reads nothing back to the host (its
top-k selections stay on the card), so the host enqueues ahead and the
events measure the card; the verify lane's host reads (the match rows,
the RANSAC's host noise) are inside its host-clock window.
"""

from __future__ import annotations

import time

import torch

from cvt_tpu_torch.benches._common import (Run, emit, full_precision,
                                           parse_args, peak_mib, reset_peak,
                                           spread, sync, timed_windows)
from cvt_tpu_torch.features.covdet import extract_sift
from cvt_tpu_torch.io.datasets import procedural_images
from cvt_tpu_torch.match.nn import match_descriptors
from cvt_tpu_torch.match.two_view import estimate_two_view_geometry

H, W = 480, 640
STAGES = ("extract", "match", "verify")
SWEEP = ((1, 8192), (4, 8192), (8, 8192), (16, 8192), (8, 2048), (16, 2048))
ITERS, EXTRACT_WINDOWS = 8, 3
MATCH_IMAGES, MATCH_K, MATCH_ITERS, MATCH_SEED = 8, 8192, 16, 1
N_VERIFY, BUCKET = 8, 1024
OPTS = dict(first_octave=-1, n_scales=3, peak_threshold=0.02 / 3,
            edge_threshold=10.0, n_orientations=2, rootsift=True)


def extract_lane(b: int, k: int, dev: torch.device, *, h: int = H,
                 w: int = W, iters: int = ITERS) -> dict:
    """One (B, K) point of the sweep on procedural_images(b, seed=b)."""
    imgs = torch.from_numpy(procedural_images(b, h, w, seed=b)).to(dev)
    reset_peak(dev)
    t = timed_windows(lambda im: extract_sift(im, max_features=k, **OPTS),
                      imgs.expand(iters, *imgs.shape), windows=EXTRACT_WINDOWS)
    nv = extract_sift(imgs, max_features=k, **OPTS).n_valid.float()
    return {"images_per_s": b / t["ms"] * 1e3, "ms_per_batch": t["ms"],
            "ms_spread": t["ms_spread"],
            "keypoints_mean": float(nv.mean()),
            "keypoints_min": float(nv.min()), "peak_mib": peak_mib(dev)}


def match_features(dev: torch.device, *, h: int = H, w: int = W,
                   k: int = MATCH_K):
    imgs = torch.from_numpy(procedural_images(MATCH_IMAGES, h, w,
                                              seed=MATCH_SEED)).to(dev)
    return extract_sift(imgs, max_features=k, **OPTS)


def match_pair(feats, i: int, j: int):
    return match_descriptors(feats.descriptors[i], feats.descriptors[j],
                             feats.valid[i], feats.valid[j], ratio=0.9,
                             cross_check=True)


def match_lane(feats, iters: int = MATCH_ITERS) -> dict:
    """Pairs (t, t+1 mod n) back to back between CUDA events."""
    n = feats.descriptors.shape[0]
    step = iter(range(1 << 62))

    def one(_):
        t = next(step)
        return match_pair(feats, t % n, (t + 1) % n)

    dev = feats.descriptors.device
    t = timed_windows(one, torch.zeros(iters, device=dev))
    return {"pairs_per_s": 1e3 / t["ms"], "ms_per_pair": t["ms"],
            "ms_spread": t["ms_spread"],
            "matches_example": int(match_pair(feats, 0, 1).valid.sum())}


def verify_pair(feats, t: int):
    """Match pair (t, t+1), pad its matched keypoints to BUCKET rows and
    estimate the two-view geometry (its own seeded generator)."""
    n = feats.descriptors.shape[0]
    i, j = t % n, (t + 1) % n
    m = match_pair(feats, i, j)
    mv = m.valid
    src = feats.frames[i][:, :2][mv][:BUCKET]
    dst = feats.frames[j][m.idx2, :2][mv][:BUCKET]
    nsrc = src.shape[0]
    pad = BUCKET - nsrc
    valid = torch.arange(BUCKET, device=src.device) < nsrc
    return estimate_two_view_geometry(
        torch.Generator().manual_seed(t),
        torch.nn.functional.pad(src, (0, 0, 0, pad)),
        torch.nn.functional.pad(dst, (0, 0, 0, pad)), valid)


def verify_lane(feats, n_verify: int = N_VERIFY) -> dict:
    dev = feats.descriptors.device
    verify_pair(feats, 0)                   # warm the bucketed shapes
    sync(dev)
    ms = []
    for t in range(n_verify):
        t0 = time.perf_counter()
        verify_pair(feats, t)
        sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    s = spread(ms)
    return {"pairs_per_s": n_verify / sum(ms) * 1e3,
            "ms_per_pair_median": s["ms"], "ms_spread": s["ms_spread"],
            "note": "match + RANSAC F/H + configuration, host in the loop"}


def main(device=None, stages=STAGES, *, sweep=SWEEP, h: int = H, w: int = W,
         iters: int = ITERS, match_k: int = MATCH_K,
         match_iters: int = MATCH_ITERS, n_verify: int = N_VERIFY) -> dict:
    """Run `stages` (the card unless asked for the CPU)."""
    bad = set(stages) - set(STAGES)
    if bad:
        raise ValueError(f"unknown stages {sorted(bad)}; use {STAGES}")
    run = Run("features", device)
    dev = run.dev
    out = {"operating_point": dict(OPTS, h=h, w=w, max_features=8192)}
    with full_precision():
        if "extract" in stages:
            out["extract"] = {
                f"b{b}_k{k}": emit(f"extract_b{b}_k{k}", extract_lane(
                    b, k, dev, h=h, w=w, iters=iters)) for b, k in sweep}
        if "match" in stages or "verify" in stages:
            feats = match_features(dev, h=h, w=w, k=match_k)
        if "match" in stages:
            out[f"match_k{match_k}"] = emit("match", match_lane(
                feats, match_iters))
        if "verify" in stages:
            out["verify_two_view"] = emit("verify", verify_lane(
                feats, n_verify))
    return run.result(**out, kernels={})


if __name__ == "__main__":
    args, device = parse_args(stage_help="comma list of extract, match, "
                                         "verify")
    main(device, tuple(args[0].split(",")) if args else STAGES)
