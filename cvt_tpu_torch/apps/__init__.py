"""End-to-end applications (counterpart of `cvt_tpu.apps`): image
retrieval, perceptual hash, image undistortion / warps; the other apps
(detect, motion_area, pupil, template_match, video_match) are imported
by module, as in `cvt_tpu`."""

from cvt_tpu_torch.apps.phash import (
    phash, hamming_distance, resize_gray_32, is_pure_image)
from cvt_tpu_torch.apps.retrieval import ImageRetrievalIndex
from cvt_tpu_torch.apps.undistort import (undistort_camera, undistort_images,
                                          warp_between_cameras,
                                          warp_image_homography)

__all__ = ["phash", "hamming_distance", "resize_gray_32", "is_pure_image",
           "ImageRetrievalIndex", "undistort_camera", "undistort_images",
           "warp_between_cameras", "warp_image_homography"]
