"""SVF spatial verification: pairwise consistency + greedy clique
(counterpart of `cvt_tpu.match.svf`).

Reference: correspondence_matching/src/svf.cc — `spaceValidate` checks,
for every PAIR of matches, (1) that the two keypoints' angle differences
agree across images and (2) that the inter-point direction (relative to
the first keypoint's orientation) agrees across images, both within 10
degrees (:37-96); `getInliers` builds the O(n^2) "brother" matrix
(:103-124) and greedily extracts the max-degree quasi-clique (:129-151).

The n^2 pairwise tests are one broadcasted expression, batched over any
leading dims (candidate images). The greedy extraction takes a node per
step and shrinks the active set to its neighbours, so it ends within n
steps; it runs on masks for all candidates at once, and the host reads
whether any set is still active once every `_CHECK_EVERY` steps (one sync
there, not one per inlier). Angle differences are wrapped circularly, as
in `cvt_tpu` (the reference compares raw degree differences).
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.match.solvers import _f32

_CHECK_EVERY = 8


def _circ_diff_deg(a, b):
    d = torch.remainder(torch.abs(a - b), 360.0)
    return torch.minimum(d, 360.0 - d)


def svf_inliers(pts1, ang1, pts2, ang2, valid=None, *,
                angle_thresh_deg: float = 10.0):
    """Pairwise-consistency inlier selection over matched keypoints.

    pts1/pts2 [..., N, 2] matched coordinates; ang1/ang2 [..., N] keypoint
    angles in RADIANS; valid [..., N] marks real matches (padded slots
    False). Returns the inlier mask [..., N] bool. Tensors keep their
    device; numpy goes to the card."""
    pts1 = _f32(pts1)
    pts2 = _f32(pts2, pts1)
    a1 = torch.rad2deg(_f32(ang1, pts1))
    a2 = torch.rad2deg(_f32(ang2, pts1))
    n = pts1.shape[-2]
    if valid is None:
        valid = torch.ones(a1.shape, dtype=torch.bool, device=pts1.device)
    else:
        valid = torch.as_tensor(valid, device=pts1.device).to(torch.bool)

    # (1) keypoint angle-difference consistency
    d_a = a1[..., :, None] - a1[..., None, :]
    d_b = a2[..., :, None] - a2[..., None, :]
    diff1 = _circ_diff_deg(d_a, d_b)

    # (2) inter-point direction consistency, relative to kp i's angle
    def rel_theta(pts, ang):
        dx = pts[..., None, :, 0] - pts[..., :, None, 0]
        dy = pts[..., None, :, 1] - pts[..., :, None, 1]
        return torch.rad2deg(torch.atan2(dy, dx)) - ang[..., :, None]

    diff2 = _circ_diff_deg(rel_theta(pts1, a1), rel_theta(pts2, a2))

    brother = ((diff1 < angle_thresh_deg) & (diff2 < angle_thresh_deg)
               & valid[..., :, None] & valid[..., None, :])
    brother &= ~torch.eye(n, dtype=torch.bool, device=pts1.device)
    bmat = brother.to(torch.float32)

    # greedy max-degree quasi-clique extraction (svf.cc:129-151)
    active = valid.clone()
    inliers = torch.zeros_like(valid)
    for step in range(n):
        deg = torch.matmul(bmat, active.to(torch.float32)[..., None])[..., 0]
        deg = torch.where(active, deg, -1.0)
        maxv, maxid = torch.max(deg, -1, keepdim=True)   # first maximum
        take = maxv > 0.0
        inliers.scatter_(-1, maxid, torch.gather(inliers, -1, maxid) | take)
        # restrict the active set to the selected node's neighbors
        row = torch.gather(bmat, -2, maxid[..., None].expand(
            maxid.shape[:-1] + (1, n)))[..., 0, :]
        active = active & (row > 0.0) & take
        if (step + 1) % _CHECK_EVERY == 0 and not bool(active.any()):
            break
    return inliers
