"""Guided matching: geometry-gated 2-NN re-matching (counterpart of
`cvt_tpu.match.guided`).

Reference: MatchGuidedSiftFeaturesCPU / the guided variants in
retrieval/vlindex/src/feature/sift.cc:252-340 — after a two-view geometry
is estimated from plain ratio matches, descriptors are RE-matched with the
candidate set restricted to pairs consistent with the estimated epipolar
geometry (fundamental/essential: point-to-epipolar-line distance) or
homography (transfer error). Guided matching recovers correspondences the
plain Lowe-ratio test rejects, because the ratio is computed only among
geometrically plausible candidates.

The geometric residual for ALL K1*K2 pairs is one broadcast matrix (no
candidate lists; the homography's [K1, K2, 2] difference is 0.5 GB at
8,192 x 8,192); pairs failing the gate get +inf distance before the same
top-2 / ratio / cross checks as `match.nn`.
"""

from __future__ import annotations

import math

import torch

from cvt_tpu_torch.match.nn import MatchResult, _distances, _mask, _two_nn
from cvt_tpu_torch.match.solvers import _f32


def _epipolar_residual_matrix(f, pts1, pts2) -> torch.Tensor:
    """Squared symmetric point-to-epipolar-line distance for all pairs.

    f [3, 3] with x2^T F x1 = 0; pts1 [K1, 2]; pts2 [K2, 2].
    Returns [K1, K2] max of the two squared line distances — the gate the
    reference applies per candidate pair (sift.cc guided match residual).
    """
    x1 = torch.cat([pts1, torch.ones_like(pts1[:, :1])], -1)   # [K1, 3]
    x2 = torch.cat([pts2, torch.ones_like(pts2[:, :1])], -1)   # [K2, 3]
    l2 = x1 @ f.T                                 # [K1, 3] lines in im2
    l1 = x2 @ f                                   # [K2, 3] lines in im1
    num = (l2 @ x2.T) ** 2                        # [K1, K2] (x2^T F x1)^2
    d2_2 = num / torch.clamp_min(l2[:, 0] ** 2 + l2[:, 1] ** 2,
                                 1e-12)[:, None]
    d2_1 = num / torch.clamp_min(l1[:, 0] ** 2 + l1[:, 1] ** 2,
                                 1e-12)[None, :]
    return torch.maximum(d2_2, d2_1)


def _homography_residual_matrix(h, pts1, pts2) -> torch.Tensor:
    """Squared transfer error ||H x1 - x2||^2 for all pairs -> [K1, K2]."""
    x1 = torch.cat([pts1, torch.ones_like(pts1[:, :1])], -1)   # [K1, 3]
    hx = x1 @ h.T                                               # [K1, 3]
    w = hx[:, 2:3]
    proj = hx[:, :2] / torch.where(torch.abs(w) > 1e-12, w, 1e-12)
    diff = proj[:, None, :] - pts2[None, :, :]                  # [K1, K2, 2]
    return torch.sum(diff * diff, -1)


_RESIDUALS = {"fundamental": _epipolar_residual_matrix,
              "essential": _epipolar_residual_matrix,
              "homography": _homography_residual_matrix}


def match_guided(d1, d2, pts1, pts2, model, *,
                 model_type: str = "fundamental",
                 max_error: float = 4.0, ratio: float = 0.9,
                 cross_check: bool = True, max_dist: float = math.inf,
                 valid1=None, valid2=None) -> MatchResult:
    """Geometry-guided 2-NN matching (sift.cc:252-340 semantics).

    d1 [K1, D], d2 [K2, D] descriptors; pts1 [K1, 2], pts2 [K2, 2]
    keypoint locations; model [3, 3] fundamental/essential-in-pixels or
    homography; max_error in pixels. The ratio + cross checks run over the
    geometrically gated candidate set only. Tensors keep their device;
    numpy goes to the card (`utils.device.resolve_device`).
    """
    if model_type not in _RESIDUALS:
        raise ValueError(f"unknown model_type {model_type!r}")
    d1 = _f32(d1)
    d2, pts1, pts2, model = (_f32(x, d1) for x in (d2, pts1, pts2, model))
    valid1 = _mask(valid1, d1.shape[0], d1)
    valid2 = _mask(valid2, d2.shape[0], d1)
    resid = _RESIDUALS[model_type](model, pts1, pts2)
    gate = resid <= max_error * max_error                     # [K1, K2]
    dist = torch.where(gate & valid2[None, :], _distances(d1, d2), math.inf)
    return _two_nn(dist, valid1, ratio, cross_check, max_dist)
