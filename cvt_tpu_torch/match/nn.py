"""Descriptor matching: 2-NN ratio test + cross-check + threshold
(counterpart of `cvt_tpu.match.nn`).

Reference: `ComputeSiftDistanceMatrix` + `FindBestMatchesBruteForce`
(retrieval/vlindex/src/feature/sift.cc:171, :55-150 — ratio and cross
checks) and the FLANN 2-NN ratio filter used everywhere else
(video_object_match/src/demo.cpp distRatio=0.9,
correspondence_matching/examples/opencv_sift_matching.cc 1nn/2nn).

The distance matrix is one float32 matrix product (full precision while
TF32 is off, see `ops/linalg.py`), formed as n1 - 2 ip + n2 in
`cvt_tpu`'s order; both nearest neighbours come from one tie-exact
top-2 (`ops/topk`: the lower index first among equal distances, as
`lax.top_k`); the cross-check's column argmin returns the first minimum,
as `jnp.argmin` does. Masks handle padded keypoint slots.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from cvt_tpu_torch.match.solvers import _f32
from cvt_tpu_torch.ops.topk import top_k_smallest


class MatchResult(NamedTuple):
    """idx2 [..., K1] best match in set 2 (int64) for each row of set 1,
    dist [..., K1] squared L2, valid [..., K1] bool (passed
    ratio/cross/threshold and both endpoints are real keypoints)."""
    idx2: torch.Tensor
    dist: torch.Tensor
    valid: torch.Tensor


def _mask(valid, k: int, like: torch.Tensor) -> torch.Tensor:
    if valid is None:
        return torch.ones((k,), dtype=torch.bool, device=like.device)
    return torch.as_tensor(valid, device=like.device).to(torch.bool)


def _distances(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[..., K1, K2] squared L2 distances, n1 - 2 ip + n2 (not clamped)."""
    n1 = torch.sum(d1 * d1, -1)
    n2 = torch.sum(d2 * d2, -1)
    return (n1[..., :, None] - 2.0 * (d1 @ d2.transpose(-1, -2))
            + n2[..., None, :])


def _two_nn(dist, valid1, ratio: float, cross_check: bool,
            max_dist: float) -> MatchResult:
    """The shared tail of plain and guided matching on a [..., K1, K2]
    matrix whose invalid (or gated) entries hold +inf. A row without a
    finite candidate fails the ratio test (inf < inf is false) and keeps
    dist +inf, as in both of `cvt_tpu`'s matchers."""
    vals, top2 = top_k_smallest(dist, 2)
    best, second = vals[..., 0], vals[..., 1]
    idx2 = top2[..., 0]
    ok = valid1 & (best < (ratio * ratio) * second) & (best < max_dist)
    if cross_check:
        dist_t = torch.where(valid1[..., :, None], dist, math.inf)
        back = torch.argmin(dist_t, dim=-2)                     # [..., K2]
        ok = ok & (torch.gather(back, -1, idx2) == torch.arange(
            dist.shape[-2], device=dist.device))
    return MatchResult(idx2=idx2, dist=torch.clamp_min(best, 0.0), valid=ok)


def match_descriptors(d1, d2, valid1=None, valid2=None, *,
                      ratio: float = 0.9, cross_check: bool = True,
                      max_dist: float = math.inf) -> MatchResult:
    """d1 [K1, D], d2 [K2, D] (unit-normalized or raw); returns per-row-of-
    d1 best match in d2. Lowe ratio test on squared distances uses
    dist1 < ratio^2 * dist2. Leading batch dims broadcast (one template
    against [T, K2, D] frames: one [T, K1, K2] product, one top-2).
    Tensors keep their device; numpy goes to the card
    (`utils.device.resolve_device`)."""
    d1 = _f32(d1)
    d2 = _f32(d2, d1)
    valid1 = _mask(valid1, d1.shape[-2], d1)
    valid2 = _mask(valid2, d2.shape[-2], d1)
    dist = torch.where(valid2[..., None, :], _distances(d1, d2), math.inf)
    return _two_nn(dist, valid1, ratio, cross_check, max_dist)
