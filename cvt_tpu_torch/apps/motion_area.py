"""Motion-area / picture-in-picture region detection (counterpart of
`cvt_tpu.apps.motion_area`).

Reference: detection_and_tracking/pip_detection —
`MotionAreaDetecion::{findMaxBBox,findTopKBBox}`
(include/motion_area_detection.h:37-55, src/motion_area_detection.cc
:22-288): frame-difference motion masks accumulated over a clip, edges +
Hough-style line accumulation to find the inner-video rectangle.

The whole clip is one [T, H, W] tensor; difference masks, box blur, and
the row/column projection profiles are batched reductions. Rectangle
finding uses axis projections of the accumulated motion mask (rows/cols
whose motion energy exceeds a fraction of the peak), the separable
equivalent of the reference's line accumulation — it returns the
dominant motion bounding box plus a coverage score. The blur's
cumulative sums are float32 scans, whose order differs from XLA's, so
the mask agrees with `cvt_tpu`'s to rounding.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cvt_tpu_torch.utils.device import resolve_device


class MotionBox(NamedTuple):
    box: torch.Tensor          # [4] (x1, y1, x2, y2) pixel coords, int32
    coverage: torch.Tensor     # fraction of motion energy inside the box
    motion_mask: torch.Tensor  # [H, W] accumulated motion energy


def _box_blur(x: torch.Tensor, r: int = 2) -> torch.Tensor:
    """[H, W] separable box blur via cumulative sums."""
    k = 2 * r + 1
    c = torch.cumsum(F.pad(x, (0, 0, r + 1, r)), 0)
    x = (c[k:] - c[:-k]) / k
    c = torch.cumsum(F.pad(x, (r + 1, r)), 1)
    return (c[:, k:] - c[:, :-k]) / k


def _extent(on: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """First index where `on`, one past the last (n and 0 when none)."""
    n = on.shape[0]
    idx = torch.arange(n, device=on.device)
    return (torch.amin(torch.where(on, idx, n)),
            torch.amax(torch.where(on, idx, -1)) + 1)


def detect_motion_area(frames, *, diff_threshold: float = 0.06,
                       profile_frac: float = 0.25,
                       device=None) -> MotionBox:
    """frames [T, H, W] gray in [0, 1] -> dominant motion bounding box.

    Mirrors the pip_detection pipeline: per-frame absolute differences ->
    threshold -> temporal accumulation -> smoothed mask -> axis-projection
    rectangle fit. A tensor keeps its device; numpy goes to `device`
    (default the card).
    """
    dev = resolve_device(device, like=frames)
    x = torch.as_tensor(frames, dtype=torch.float32, device=dev)
    mask = (torch.abs(x[1:] - x[:-1]) > diff_threshold).to(torch.float32)
    acc = _box_blur(torch.mean(mask, 0), 2)                  # [H, W]

    rows = torch.sum(acc, 1)                                 # [H]
    cols = torch.sum(acc, 0)                                 # [W]
    y1, y2 = _extent(rows > profile_frac * torch.amax(rows))
    x1, x2 = _extent(cols > profile_frac * torch.amax(cols))
    h, w = acc.shape
    ridx = torch.arange(h, device=dev)[:, None]
    cidx = torch.arange(w, device=dev)[None, :]
    inside = (ridx >= y1) & (ridx < y2) & (cidx >= x1) & (cidx < x2)
    total = torch.clamp_min(torch.sum(acc), 1e-9)
    coverage = torch.sum(torch.where(inside, acc, 0.0)) / total
    return MotionBox(box=torch.stack([x1, y1, x2, y2]).to(torch.int32),
                     coverage=coverage, motion_mask=acc)


def find_topk_boxes(frames, k: int = 3, *, device=None, **kwargs):
    """Iteratively extract up to k motion boxes (findTopKBBox equivalent):
    detect, zero the winning region, repeat (host loop; k is tiny)."""
    res = detect_motion_area(frames, device=device, **kwargs)
    mask = res.motion_mask.clone()
    total = float(torch.sum(res.motion_mask))
    boxes, coverages = [], []
    for _ in range(k):
        rows = torch.sum(mask, 1)
        cols = torch.sum(mask, 0)
        if float(torch.amax(rows)) <= 0:
            break
        # reuse the projection fit on the remaining mask
        y1, y2 = (int(v) for v in _extent(rows > 0.25 * torch.amax(rows)))
        x1, x2 = (int(v) for v in _extent(cols > 0.25 * torch.amax(cols)))
        cov = float(torch.sum(mask[y1:y2, x1:x2])) / max(total, 1e-9)
        boxes.append((x1, y1, x2, y2))
        coverages.append(cov)
        mask[y1:y2, x1:x2] = 0.0
    return boxes, coverages
