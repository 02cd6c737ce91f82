"""End-to-end applications (the ported part of `cvt_tpu.apps`): image
retrieval over local descriptors and image undistortion / warps."""

from cvt_tpu_torch.apps.retrieval import ImageRetrievalIndex
from cvt_tpu_torch.apps.undistort import (undistort_camera, undistort_images,
                                          warp_between_cameras,
                                          warp_image_homography)

__all__ = ["ImageRetrievalIndex", "undistort_camera", "undistort_images",
           "warp_between_cameras", "warp_image_homography"]
