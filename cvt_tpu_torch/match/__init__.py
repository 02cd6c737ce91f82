"""Descriptor matching, spatial verification, robust estimation and
two-view geometry (the ported part of `cvt_tpu.match`)."""

from cvt_tpu_torch.match.nn import match_descriptors, MatchResult
from cvt_tpu_torch.match.guided import match_guided
from cvt_tpu_torch.match.svf import svf_inliers
from cvt_tpu_torch.match.solvers import (
    fit_affine, fit_homography_dlt, apply_affine, apply_homography,
    fit_translation, apply_translation, fit_similarity2d,
    apply_similarity2d)
from cvt_tpu_torch.match.ransac import (
    ransac, ransac_preemptive, RansacResult, progressive_minimal_samples,
    combination_minimal_samples, n_combinations)
from cvt_tpu_torch.match.vote_verify import vote_and_verify, VoteVerifyResult
from cvt_tpu_torch.match.epipolar import (
    fit_fundamental_8pt, fit_fundamental_7pt, fit_essential_5pt,
    solve_cubic_real, essential_from_fundamental, sampson_error,
    ransac_fundamental, ransac_essential)
from cvt_tpu_torch.match.pose import (
    triangulate_dlt, decompose_essential, pose_from_essential)
from cvt_tpu_torch.match.two_view import (
    TwoViewGeometry, estimate_two_view_geometry, epipolar_inliers)

__all__ = [
    "match_descriptors", "MatchResult", "match_guided", "svf_inliers",
    "fit_fundamental_7pt", "fit_essential_5pt", "solve_cubic_real",
    "fit_affine", "fit_homography_dlt", "apply_affine", "apply_homography",
    "fit_translation", "apply_translation", "fit_similarity2d",
    "apply_similarity2d", "ransac", "ransac_preemptive", "RansacResult",
    "fit_fundamental_8pt", "essential_from_fundamental", "sampson_error",
    "ransac_fundamental", "ransac_essential",
    "triangulate_dlt", "decompose_essential", "pose_from_essential",
    "TwoViewGeometry", "estimate_two_view_geometry", "epipolar_inliers",
    "progressive_minimal_samples", "combination_minimal_samples",
    "n_combinations", "vote_and_verify", "VoteVerifyResult",
]
