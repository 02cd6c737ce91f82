"""Scale-space keypoint detection + SIFT descriptors, line segments,
global image and text embeddings, batched on the card (counterpart of
`cvt_tpu.features`)."""

from cvt_tpu_torch.features.scale_space import build_pyramid, OctavePyramid
from cvt_tpu_torch.features.detect import (detect_octave, hessian_response,
                                           Keypoints)
from cvt_tpu_torch.features.affine import estimate_affine_shape
from cvt_tpu_torch.features.descriptor import (
    assign_orientations, assign_orientations_multi, sift_descriptors,
    root_sift, bilinear_sample)
from cvt_tpu_torch.features.covdet import extract_sift, SiftFeatures
from cvt_tpu_torch.features.lines import detect_line_segments, LineSegments

__all__ = [
    "build_pyramid", "OctavePyramid", "detect_octave", "hessian_response",
    "estimate_affine_shape", "Keypoints",
    "assign_orientations", "assign_orientations_multi",
    "sift_descriptors", "root_sift",
    "bilinear_sample", "extract_sift", "SiftFeatures",
    "detect_line_segments", "LineSegments",
]
