"""Relative pose from two views: essential-matrix decomposition, chirality
and two-view triangulation (the part of `cvt_tpu.match.pose` that two-view
geometry uses).

Reference: vlindex/src/estimators/ — essential_matrix decomposition +
chirality (PoseFromEssentialMatrix in base/pose.cc), triangulation.{h,cc}.
Triangulation is the batched two-view DLT. Rotations are [..., 3, 3],
translations [..., 3], with camera convention x_cam = R @ x_world + t.
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.match.epipolar import _svd
from cvt_tpu_torch.match.solvers import _f32

_EPS = 1e-12


def triangulate_dlt(r1, t1, r2, t2, x1, x2) -> torch.Tensor:
    """Two-view linear triangulation. (r_i, t_i) world->cam poses;
    x1/x2 [..., n, 2] normalized coords. Returns world points [..., n, 3].
    """
    p1 = torch.cat([r1, t1[..., :, None]], -1)               # [..., 3, 4]
    p2 = torch.cat([r2, t2[..., :, None]], -1)

    def rows(p, x):
        # x [..., n, 2]; p [..., 3, 4] -> [..., n, 2, 4]
        pe = p[..., None, :, :]
        return torch.stack([x[..., 0:1] * pe[..., 2, :] - pe[..., 0, :],
                            x[..., 1:2] * pe[..., 2, :] - pe[..., 1, :]],
                           -2)

    a = torch.cat([rows(p1, x1), rows(p2, x2)], -2)          # [..., n, 4, 4]
    xh = _svd(a)[2][..., -1, :]
    w = xh[..., 3:]
    return xh[..., :3] / torch.where(torch.abs(w) < _EPS, _EPS, w)


def decompose_essential(e):
    """E -> 4 candidate (R, t): (R1,t), (R1,-t), (R2,t), (R2,-t).
    Returns (r [..., 4, 3, 3], t [..., 4, 3])."""
    e = _f32(e)
    u, _, vt = _svd(e)
    # enforce proper rotations
    u = u * torch.linalg.det(u)[..., None, None]
    vt = vt * torch.linalg.det(vt)[..., None, None]
    w = torch.tensor([[0., -1., 0.], [1., 0., 0.], [0., 0., 1.]],
                     dtype=e.dtype, device=e.device)
    r1 = torch.einsum("...ij,jk,...kl->...il", u, w, vt)
    r2 = torch.einsum("...ij,jk,...kl->...il", u, w.T, vt)
    t = u[..., :, 2]
    return (torch.stack([r1, r1, r2, r2], -3),
            torch.stack([t, -t, t, -t], -2))


def pose_from_essential(e, x1, x2, valid=None):
    """Pick the (R, t) among the 4 decompositions with the most points
    passing the chirality test (positive depth in both views; the first
    of equal counts).

    x1/x2 [n, 2] normalized coords. Returns (R, t, n_cheiral).
    Reference semantics: base/pose.cc PoseFromEssentialMatrix.
    """
    e = _f32(e)
    x1 = _f32(x1, e)
    x2 = _f32(x2, e)
    if valid is None:
        valid = torch.ones(x1.shape[:-1], dtype=torch.bool, device=e.device)
    r4, t4 = decompose_essential(e)                        # [4,3,3], [4,3]
    eye = torch.eye(3, dtype=e.dtype, device=e.device).expand(r4.shape)
    pts = triangulate_dlt(eye, torch.zeros_like(t4), r4, t4,
                          x1.expand((4,) + x1.shape),
                          x2.expand((4,) + x2.shape))
    z1 = pts[..., 2]
    cam2 = torch.einsum("...ij,...nj->...ni", r4, pts) + t4[..., None, :]
    good = (z1 > 0) & (cam2[..., 2] > 0) & valid[None, :]
    counts = torch.sum(good, -1)
    best = torch.argmax(counts)
    return r4[best], t4[best], counts[best]
