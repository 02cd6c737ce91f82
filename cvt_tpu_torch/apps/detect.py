"""Anchor-free detection post-processing: box decode + batched NMS
(counterpart of `cvt_tpu.apps.detect`).

Reference: detection_and_tracking/fastest_det — FastestDet ONNX head
decoded in C++ (examples/fastest_det_demo.cc:63-142: sigmoid objectness x
class score, softmax-free box offsets, then OpenCV NMSBoxes) and Python
(python/main.py). The network itself is an external artifact there
(ONNX); the framework capability is the DECODE + NMS pipeline, which
here runs batched on the card: decode is elementwise over the
[B, H, W, C] head output and one tie-exact top-k (`ops/topk`, the lower
cell first among equal scores, as `jax.lax.top_k`); NMS keeps
`cvt_tpu`'s greedy order over K fixed slots as K masked steps, each over
the whole batch (no dynamic-length boxes).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.utils.device import resolve_device


class Detections(NamedTuple):
    boxes: torch.Tensor    # [B, K, 4] (x1, y1, x2, y2) normalized
    scores: torch.Tensor   # [B, K]
    classes: torch.Tensor  # [B, K] int32
    valid: torch.Tensor    # [B, K] bool


def decode_fastestdet(head, *, max_dets: int = 64,
                      score_threshold: float = 0.65,
                      device=None) -> Detections:
    """Decode a FastestDet-style head [B, H, W, 5 + n_classes]:
    channels = (obj, cx_off, cy_off, w, h, class logits...). Matches the
    reference decode (fastest_det_demo.cc:63-120): score =
    sqrt(obj * max_class_prob); offsets pass tanh/sigmoid squashing;
    boxes normalized to [0, 1]. A tensor keeps its device; numpy goes to
    `device` (default the card).
    """
    dev = resolve_device(device, like=head)
    head = torch.as_tensor(head, dtype=torch.float32, device=dev)
    b, h, w, c = head.shape
    obj = torch.sigmoid(head[..., 0])
    off = torch.tanh(head[..., 1:3])
    wh = torch.sigmoid(head[..., 3:5])
    cls_prob = torch.softmax(head[..., 5:], dim=-1)
    best_p, best_cls = torch.max(cls_prob, dim=-1)        # first maximum
    score = torch.sqrt(torch.clamp_min(obj * best_p, 0.0))       # [B, H, W]

    gx = (torch.arange(w, dtype=torch.float32, device=dev)[None, None, :]
          + 0.5 + off[..., 0]) / w
    gy = (torch.arange(h, dtype=torch.float32, device=dev)[None, :, None]
          + 0.5 + off[..., 1]) / h
    bw, bh = wh[..., 0], wh[..., 1]
    boxes = torch.stack([gx - bw / 2, gy - bh / 2,
                         gx + bw / 2, gy + bh / 2], dim=-1)      # [B,H,W,4]

    topv, topi = top_k_largest(score.reshape(b, -1), min(max_dets, h * w))
    sel_boxes = torch.gather(boxes.reshape(b, h * w, 4), 1,
                             topi[..., None].expand(-1, -1, 4))
    sel_cls = torch.gather(best_cls.reshape(b, -1), 1, topi)
    return Detections(boxes=sel_boxes, scores=topv,
                      classes=sel_cls.to(torch.int32),
                      valid=topv > score_threshold)


def _iou(a, b):
    """a [..., K, 4], b [..., K, 4] -> [..., K, K] IoU."""
    x1 = torch.maximum(a[..., :, None, 0], b[..., None, :, 0])
    y1 = torch.maximum(a[..., :, None, 1], b[..., None, :, 1])
    x2 = torch.minimum(a[..., :, None, 2], b[..., None, :, 2])
    y2 = torch.minimum(a[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp_min(x2 - x1, 0) * torch.clamp_min(y2 - y1, 0)

    def area(z):
        return (torch.clamp_min(z[..., 2] - z[..., 0], 0)
                * torch.clamp_min(z[..., 3] - z[..., 1], 0))
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-9)


def nms(dets: Detections, *, iou_threshold: float = 0.35,
        class_aware: bool = True) -> Detections:
    """Masked greedy NMS over fixed-size detection slots (the batched
    replacement for cv::dnn::NMSBoxes). Boxes must be sorted by score
    (decode_fastestdet emits them sorted). Step i, for every image at
    once, lets slot i (if still kept) suppress every later slot of the
    same class that overlaps it by more than iou_threshold."""
    iou = _iou(dets.boxes, dets.boxes)                       # [B, K, K]
    sup = iou > iou_threshold
    if class_aware:
        sup = sup & (dets.classes[..., :, None] == dets.classes[..., None, :])
    k = dets.boxes.shape[1]
    later = torch.triu(torch.ones((k, k), dtype=torch.bool,
                                  device=iou.device), diagonal=1)
    sup = sup & later                          # row i: slots after i only
    keep = dets.valid.clone()
    for i in range(k):
        keep = keep & ~(sup[:, i] & keep[:, i:i + 1])
    return dets._replace(valid=dets.valid & keep)
