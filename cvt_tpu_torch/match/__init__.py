"""Descriptor matching, spatial verification, robust estimation, two-view
geometry, camera models, pose, bundle adjustment and the reconstruction
(the ported part of `cvt_tpu.match`)."""

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
from cvt_tpu_torch.match.lad import solve_lad, LADResult
from cvt_tpu_torch.match.pose import (
    p3p, kabsch, fit_pnp_dlt, ransac_pnp, triangulate_dlt,
    decompose_essential, pose_from_essential, solve_quartic,
    gp3p, ransac_gp3p, similarity_transform,
    fit_generalized_relative_pose, ransac_generalized_relative_pose)
from cvt_tpu_torch.match.cameras import (
    world_to_image, image_to_world, calibration_matrix)
from cvt_tpu_torch.match.two_view import (
    TwoViewGeometry, estimate_two_view_geometry, epipolar_inliers)
from cvt_tpu_torch.match.reconstruction import (
    CorrespondenceGraph, Reconstruction, Point3D, triangulate_tracks,
    reprojection_errors)
from cvt_tpu_torch.match.scene_graph_utils import (
    SceneCluster, cluster_scene, min_st_cut, normalized_cut,
    VisibilityPyramid)
from cvt_tpu_torch.match import gps

__all__ = [
    "match_descriptors", "MatchResult", "match_guided", "svf_inliers",
    "fit_fundamental_7pt", "fit_essential_5pt", "solve_cubic_real",
    "fit_affine", "fit_homography_dlt", "apply_affine", "apply_homography",
    "fit_translation", "apply_translation", "fit_similarity2d",
    "apply_similarity2d", "ransac", "ransac_preemptive", "RansacResult",
    "fit_fundamental_8pt", "essential_from_fundamental", "sampson_error",
    "ransac_fundamental", "ransac_essential",
    "p3p", "kabsch", "fit_pnp_dlt", "ransac_pnp", "triangulate_dlt",
    "decompose_essential", "pose_from_essential", "solve_quartic",
    "world_to_image", "image_to_world", "calibration_matrix",
    "TwoViewGeometry", "estimate_two_view_geometry", "epipolar_inliers",
    "CorrespondenceGraph", "Reconstruction", "Point3D",
    "triangulate_tracks", "reprojection_errors", "gps",
    "gp3p", "ransac_gp3p", "similarity_transform",
    "fit_generalized_relative_pose", "ransac_generalized_relative_pose",
    "progressive_minimal_samples", "SceneCluster", "cluster_scene",
    "min_st_cut", "normalized_cut", "VisibilityPyramid",
    "combination_minimal_samples", "n_combinations", "solve_lad",
    "LADResult", "vote_and_verify", "VoteVerifyResult",
]
