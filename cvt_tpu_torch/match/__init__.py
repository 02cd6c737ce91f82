"""Geometric solvers, spatial verification (SVF, vote-and-verify) and
batched RANSAC (the ported part of `cvt_tpu.match`)."""

from cvt_tpu_torch.match.svf import svf_inliers
from cvt_tpu_torch.match.solvers import (
    fit_affine, fit_homography_dlt, apply_affine, apply_homography,
    fit_translation, apply_translation, fit_similarity2d,
    apply_similarity2d)
from cvt_tpu_torch.match.ransac import (
    ransac, ransac_preemptive, RansacResult, progressive_minimal_samples,
    combination_minimal_samples, n_combinations)
from cvt_tpu_torch.match.vote_verify import vote_and_verify, VoteVerifyResult

__all__ = [
    "svf_inliers",
    "fit_affine", "fit_homography_dlt", "apply_affine", "apply_homography",
    "fit_translation", "apply_translation", "fit_similarity2d",
    "apply_similarity2d", "ransac", "ransac_preemptive", "RansacResult",
    "progressive_minimal_samples", "combination_minimal_samples",
    "n_combinations", "vote_and_verify", "VoteVerifyResult",
]
