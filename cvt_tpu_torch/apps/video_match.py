"""Video object match: find frames in a video containing a template
(counterpart of `cvt_tpu.apps.video_match`).

Reference: video_object_match/src/demo.cpp:46-166 — FFmpeg in-memory
decode -> per-frame SIFT -> FLANN 2-NN ratio match (distRatio=0.9) ->
GHT validation (SVF spatial + octave histogram, GHT.cpp:6-180) ->
optional cv::findHomography RANSAC (GHT.cpp:238-255, threshold 10) ->
report frames with >= numThrehold (10) verified inliers.

Decode is host-side (`io.video.VideoReader`); frames are batched into
fixed [T, H, W] stacks, and SIFT extraction and the whole match/verify
stack run batched on the card through TemplateMatcher (one extract_sift
per batch, verification with the frames as a batch dim — no per-frame
device round-trips). RANSAC draws from a `torch.Generator` (`gen`, seed
0 when None) in place of `cvt_tpu`'s `key`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cvt_tpu_torch.apps.template_match import TemplateMatcher
from cvt_tpu_torch.io.video import VideoReader


@dataclass
class VideoMatchResult:
    """Frames (global indices) where the template was verified."""
    frame_ids: np.ndarray                  # [F] int64
    n_inliers: np.ndarray                  # [F] int32
    models: np.ndarray                     # [F, 2, 3] affine template->frame
    n_frames: int = 0
    timestamps: np.ndarray = field(default=None)   # [F] seconds (if fps known)


class VideoObjectMatcher:
    """Template-in-video search over batched decoded frames."""

    def __init__(self, template_image, *, batch_size: int = 8,
                 frame_stride: int = 1,
                 target_size: tuple[int, int] | None = None,
                 min_inliers: int = 10, device=None, **matcher_kwargs):
        """template_image [H, W] gray in [0, 1]; runs on `device`
        (default: the card)."""
        matcher_kwargs.setdefault("min_matches", min_inliers)
        self.matcher = TemplateMatcher(template_image, device=device,
                                       **matcher_kwargs)
        self.batch_size = batch_size
        self.frame_stride = frame_stride
        self.target_size = target_size

    def match_video(self, source, gen=None) -> VideoMatchResult:
        """source: path or raw encoded bytes (in-memory decode)."""
        reader = VideoReader(source, gray=True, frame_stride=self.frame_stride,
                             target_size=self.target_size)
        fps = reader.fps
        hit_ids, hit_inl, hit_models = [], [], []
        n_seen = 0
        for frames, n_valid in reader.batches(self.batch_size):
            res = self.matcher.match_frames(frames, gen=gen)
            for t in range(n_valid):
                if res.hits[t]:
                    hit_ids.append(n_seen + t)
                    hit_inl.append(int(res.n_inliers[t]))
                    hit_models.append(res.models[t])
            n_seen += n_valid
        reader.release()
        ids = np.asarray(hit_ids, np.int64) * self.frame_stride
        ts = (ids / fps if fps > 0 else None)
        return VideoMatchResult(
            frame_ids=ids,
            n_inliers=np.asarray(hit_inl, np.int32),
            models=(np.stack(hit_models) if hit_models
                    else np.zeros((0, 2, 3), np.float32)),
            n_frames=n_seen * self.frame_stride,
            timestamps=ts)

    def match_frames(self, frames, gen=None) -> VideoMatchResult:
        """Match an already-decoded [T, H, W] frame stack."""
        res = self.matcher.match_frames(frames, gen=gen)
        ids = np.nonzero(res.hits)[0].astype(np.int64)
        return VideoMatchResult(
            frame_ids=ids,
            n_inliers=res.n_inliers[ids].astype(np.int32),
            models=res.models[ids],
            n_frames=len(res.hits))
