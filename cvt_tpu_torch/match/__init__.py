"""Geometric solvers and vote-and-verify spatial verification (the
ported part of `cvt_tpu.match`)."""

from cvt_tpu_torch.match.solvers import (
    fit_affine, fit_homography_dlt, apply_affine, apply_homography,
    fit_translation, apply_translation, fit_similarity2d,
    apply_similarity2d)
from cvt_tpu_torch.match.vote_verify import vote_and_verify, VoteVerifyResult

__all__ = [
    "fit_affine", "fit_homography_dlt", "apply_affine", "apply_homography",
    "fit_translation", "apply_translation", "fit_similarity2d",
    "apply_similarity2d", "vote_and_verify", "VoteVerifyResult",
]
