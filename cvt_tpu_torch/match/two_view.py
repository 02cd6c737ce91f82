"""Two-view geometry estimation + configuration classification
(counterpart of `cvt_tpu.match.two_view`).

Reference: vlindex/src/estimators/two_view_geometry.{h,cc} — COLMAP's
decision logic: estimate fundamental F, homography H (and essential E
when calibrated), compare inlier counts, and classify the pair as
CALIBRATED / UNCALIBRATED / PLANAR / PANORAMIC / PLANAR_OR_PANORAMIC /
DEGENERATE; inliers of the winning model are the verified matches the
matching pipeline stores.

Both models come from the batched-hypothesis RANSACs (match.ransac /
match.epipolar) on the points' device; the classification is host logic
on three inlier counts, mirroring two_view_geometry.cc's H_F
inlier-ratio rule (max_H_inlier_ratio 0.8).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvt_tpu_torch.match.epipolar import (essential_from_fundamental,
                                          ransac_essential,
                                          ransac_fundamental, sampson_error)
from cvt_tpu_torch.match.pose import pose_from_essential
from cvt_tpu_torch.match.ransac import _prepare, ransac
from cvt_tpu_torch.match.solvers import _f32

# configurations (two_view_geometry.h enum)
DEGENERATE = 1
CALIBRATED = 2
UNCALIBRATED = 3
PLANAR = 4
PANORAMIC = 5
PLANAR_OR_PANORAMIC = 6

CONFIG_NAMES = {
    DEGENERATE: "degenerate", CALIBRATED: "calibrated",
    UNCALIBRATED: "uncalibrated", PLANAR: "planar",
    PANORAMIC: "panoramic", PLANAR_OR_PANORAMIC: "planar_or_panoramic",
}


@dataclass
class TwoViewGeometry:
    config: int
    f: np.ndarray | None          # [3, 3] fundamental, PIXEL space (epipolar configs)
    h: np.ndarray | None          # [3, 3] homography (planar configs)
    inliers: np.ndarray           # [N] bool — winning model's inliers
    n_inliers: int
    # relative pose (filled when intrinsics are given)
    r: np.ndarray | None = None
    t: np.ndarray | None = None
    # essential matrix in NORMALIZED coords (CALIBRATED only) — kept in its
    # own field, like the reference's separate E/F/H members
    # (two_view_geometry.h:251-255); `f` stays pixel-space so downstream
    # Sampson gating (epipolar_inliers, guided matching, DB persistence)
    # is always on pixel coordinates.
    e: np.ndarray | None = None

    @property
    def config_name(self) -> str:
        return CONFIG_NAMES.get(self.config, "unknown")


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def estimate_two_view_geometry(gen, src, dst, valid=None, *,
                               k1: np.ndarray | None = None,
                               k2: np.ndarray | None = None,
                               f_threshold: float = 4.0,
                               h_threshold: float = 12.0,
                               min_inliers: int = 15,
                               max_h_inlier_ratio: float = 0.8,
                               min_e_f_inlier_ratio: float = 0.95,
                               n_hypotheses: int = 256) -> TwoViewGeometry:
    """Estimate F and H for matched points src/dst [N, 2] (pixels) and
    classify the configuration. With intrinsics k1/k2 [3,3], E is ALSO
    estimated directly via the 5-point RANSAC (the reference's
    EstimateCalibrated path, two_view_geometry.cc): the pair is
    CALIBRATED when E supports >= min_e_f_inlier_ratio of F's inliers
    (E's stricter model holding up means the intrinsics are right), and
    the relative pose (R, t) comes from E + chirality.

    gen: one torch.Generator (None means seed 0), drawn from in a fixed
    order: F's samples, then H's, then E's. Tensors keep their device;
    numpy goes to the card (`utils.device.resolve_device`). The result
    holds numpy arrays, as `cvt_tpu`'s does.
    """
    src, dst, valid = _prepare(src, dst, valid)
    n = src.shape[0]
    if gen is None:
        gen = torch.Generator().manual_seed(0)

    fmat, f_inl, f_n = ransac_fundamental(
        gen, src, dst, valid, threshold=f_threshold,
        n_hypotheses=n_hypotheses)
    hres = ransac(gen, src, dst, valid, model="homography",
                  threshold=h_threshold, n_hypotheses=n_hypotheses,
                  lo_iters=0, min_inliers=min_inliers)
    f_n_i = int(f_n)
    h_n_i = int(hres.n_inliers)

    calibrated = k1 is not None and k2 is not None
    e_n_i = 0
    emat = e_inl = None
    if calibrated:
        k1t = _f32(k1, src)
        k2t = _f32(k2, src)
        x1 = _normalize_points(src, k1t)
        x2 = _normalize_points(dst, k2t)
        # pixel threshold -> normalized units via the mean focal length
        focal = float(np.mean([k1[0][0], k1[1][1], k2[0][0], k2[1][1]]))
        emat, e_inl, e_n = ransac_essential(
            gen, x1, x2, valid, threshold=f_threshold / focal,
            n_hypotheses=max(32, n_hypotheses // 4))
        e_n_i = int(e_n)

    if max(f_n_i, h_n_i, e_n_i) < min_inliers:
        return TwoViewGeometry(DEGENERATE, None, None, np.zeros(n, bool), 0)

    h_f_ratio = h_n_i / max(f_n_i, e_n_i, 1)
    if h_f_ratio > max_h_inlier_ratio:
        # planar or pure-rotation scene: homography wins
        return TwoViewGeometry(PLANAR_OR_PANORAMIC, _host(fmat),
                               _host(hres.model), _host(hres.inliers), h_n_i)
    if calibrated and e_n_i >= min_e_f_inlier_ratio * max(f_n_i, 1):
        # E holds up against F: CALIBRATED; pose from the 5-point E. `f`
        # keeps the pixel-space F from the F-RANSAC (the reference stores
        # both, two_view_geometry.h:251-255); E goes in its own field.
        rr, tt, _ = pose_from_essential(emat, x1, x2, e_inl)
        return TwoViewGeometry(CALIBRATED, _host(fmat), None, _host(e_inl),
                               e_n_i, r=_host(rr), t=_host(tt),
                               e=_host(emat))
    r = t = None
    if calibrated:
        # intrinsics unreliable for this pair: fall back to F, pose via
        # E-from-F (the reference's UNCALIBRATED-with-prior behavior)
        e = essential_from_fundamental(fmat, k1t, k2t)
        rr, tt, _ = pose_from_essential(e, x1, x2, f_inl)
        r, t = _host(rr), _host(tt)
    return TwoViewGeometry(UNCALIBRATED, _host(fmat), None, _host(f_inl),
                           f_n_i, r=r, t=t)


def _normalize_points(pts, k):
    """Pixels -> normalized coords via K^-1 (pinhole)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    x = torch.einsum("ij,nj->ni", torch.linalg.inv(k), ph)
    return x[..., :2] / x[..., 2:3]


def epipolar_inliers(f, src, dst, threshold: float = 4.0) -> torch.Tensor:
    """Mask of correspondences within Sampson distance of F."""
    return sampson_error(f, src, dst) < threshold * threshold
