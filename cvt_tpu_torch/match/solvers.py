"""Minimal solvers for 2D geometric models (counterpart of
`cvt_tpu.match.solvers`).

Reference: covdet/geo_verification.hpp (affine -> normalized DLT
homography, `toAffinity` :217-256, `centering` :181-212) and vlindex's
estimators (affine_transform.h, homography_matrix 4-pt DLT with Hartley
normalization, translation_transform.h, similarity_transform.h).

All solvers are batched: [..., n, 2] point sets -> [..., ...] models.
Tensors keep their device; numpy input goes to the card
(`utils.device.resolve_device`).
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.utils.device import resolve_device


def _f32(x, like=None) -> torch.Tensor:
    """x as float32 on its own device (a tensor), else on like's device
    when like is a tensor, else on the card."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.as_tensor(x, dtype=torch.float32,
                           device=resolve_device(None, like=like))


def fit_affine(src, dst, weights=None) -> torch.Tensor:
    """Least-squares affine A (2x3) with dst ~= A @ [src; 1].

    src/dst [..., n, 2] (n >= 3); weights [..., n]. Batched closed-form
    normal equations, regularised by 1e-6 I. A singular system (one or
    two weighted points far from the origin) gives a non-finite model and
    no error, as `jnp.linalg.solve` does (`torch.linalg.solve` raises)."""
    src = _f32(src)
    dst = _f32(dst, src)
    x = torch.cat([src, torch.ones_like(src[..., :1])], -1)     # [..., n, 3]
    xw = x if weights is None else x * _f32(weights, src)[..., None]
    xtx = torch.einsum("...ni,...nj->...ij", xw, x)
    xty = torch.einsum("...ni,...nj->...ij", xw, dst)
    eye = torch.eye(3, dtype=torch.float32, device=src.device) * 1e-6
    sol = torch.linalg.solve_ex(xtx + eye, xty)[0]             # [..., 3, 2]
    return sol.mT                                              # [..., 2, 3]


def apply_affine(a, pts) -> torch.Tensor:
    """a [..., 2, 3], pts [..., n, 2] -> [..., n, 2]."""
    a = _f32(a)
    pts = _f32(pts, a)
    return (torch.einsum("...ij,...nj->...ni", a[..., :2], pts)
            + a[..., None, :, 2])


def _hartley_normalize(pts: torch.Tensor, weights=None):
    """Similarity transform T s.t. T(pts) has zero mean, sqrt(2) RMS.

    With `weights` [..., n], the mean and scale are weighted (zero-weight
    points do not influence the conditioning transform)."""
    if weights is None:
        mean = torch.mean(pts, -2, keepdim=True)
        d = torch.sqrt(torch.sum((pts - mean) ** 2, -1))
        scale = 2.0 ** 0.5 / (torch.mean(d, -1, keepdim=True) + 1e-12)
    else:
        w = weights[..., None]
        wsum = torch.clamp_min(torch.sum(w, -2, keepdim=True), 1e-12)
        mean = torch.sum(pts * w, -2, keepdim=True) / wsum
        d = torch.sqrt(torch.sum((pts - mean) ** 2, -1))
        scale = 2.0 ** 0.5 / (torch.sum(d * weights, -1, keepdim=True)
                              / wsum[..., 0] + 1e-12)
    sc = scale[..., 0]
    zero, one = torch.zeros_like(sc), torch.ones_like(sc)
    t = torch.stack([
        torch.stack([sc, zero, -sc * mean[..., 0, 0]], -1),
        torch.stack([zero, sc, -sc * mean[..., 0, 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)                # [..., 3, 3]
    return (pts - mean) * scale[..., None], t


def fit_homography_dlt(src, dst, weights=None) -> torch.Tensor:
    """Normalized 4+-point DLT homography H (3x3, h22 = 1).

    src/dst [..., n, 2] (n >= 4). Batched SVD of the 2n x 9 system with
    Hartley normalization (geo_verification.hpp:117-160 semantics).
    Optional `weights` [..., n] give a weighted least-squares fit (rows
    scaled by sqrt(w)) for LO-RANSAC inlier refits."""
    src = _f32(src)
    dst = _f32(dst, src)
    if weights is not None:
        weights = _f32(weights, src)
    sn, t1 = _hartley_normalize(src, weights)
    dn, t2 = _hartley_normalize(dst, weights)
    x, y = sn[..., 0], sn[..., 1]
    u, v = dn[..., 0], dn[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, u * x, u * y, u], -1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, v * x, v * y, v], -1)
    if weights is not None:
        sw = torch.sqrt(weights)[..., None]
        r1, r2 = r1 * sw, r2 * sw
    a = torch.cat([r1, r2], -2)                                 # [..., 2n, 9]
    _, _, vt = torch.linalg.svd(a, full_matrices=True)
    h = vt[..., -1, :].reshape(src.shape[:-2] + (3, 3))
    # denormalize: H = T2^-1 Hn T1
    h = torch.linalg.solve_ex(t2, h @ t1)[0]
    return h / (h[..., 2:3, 2:3] + 1e-12)


def apply_homography(h, pts) -> torch.Tensor:
    """h [..., 3, 3], pts [..., n, 2] -> projected [..., n, 2]."""
    h = _f32(h)
    pts = _f32(pts, h)
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
    out = torch.einsum("...ij,...nj->...ni", h, ph)
    return out[..., :2] / (out[..., 2:3] + 1e-12)


def fit_translation(src, dst, weights=None) -> torch.Tensor:
    """2-D translation (estimators/translation_transform.h): the weighted
    mean displacement. src/dst [..., n, 2] -> [..., 2]."""
    src = _f32(src)
    dst = _f32(dst, src)
    if weights is None:
        return torch.mean(dst - src, -2)
    w = _f32(weights, src)[..., None]
    return (torch.sum((dst - src) * w, -2)
            / torch.clamp_min(torch.sum(w, -2), 1e-12))


def apply_translation(t, pts) -> torch.Tensor:
    t = _f32(t)
    return _f32(pts, t) + t[..., None, :]


def fit_similarity2d(src, dst, weights=None) -> torch.Tensor:
    """2-D similarity (scale + rotation + translation) as a [2, 3] matrix,
    the closed-form complex least squares (dst ~ s*R*src + t). Batched;
    weights optional (estimators/similarity_transform.h at 2-D)."""
    src = _f32(src)
    dst = _f32(dst, src)
    weights = (torch.ones_like(src[..., 0]) if weights is None
               else _f32(weights, src))
    w = weights[..., None] / (torch.sum(weights, -1)[..., None, None]
                              + 1e-12)
    mu_s = torch.sum(src * w, -2, keepdim=True)
    mu_d = torch.sum(dst * w, -2, keepdim=True)
    s0 = src - mu_s
    d0 = dst - mu_d
    # complex regression: (a + ib) = sum(conj(s) d) / sum(|s|^2)
    num_re = torch.sum((s0[..., 0] * d0[..., 0]
                        + s0[..., 1] * d0[..., 1]) * weights, -1)
    num_im = torch.sum((s0[..., 0] * d0[..., 1]
                        - s0[..., 1] * d0[..., 0]) * weights, -1)
    den = torch.clamp_min(torch.sum((s0[..., 0] ** 2 + s0[..., 1] ** 2)
                                    * weights, -1), 1e-12)
    a = num_re / den
    b = num_im / den
    rot = torch.stack([torch.stack([a, -b], -1),
                       torch.stack([b, a], -1)], -2)
    t = mu_d[..., 0, :] - torch.einsum("...ij,...j->...i", rot,
                                       mu_s[..., 0, :])
    return torch.cat([rot, t[..., :, None]], -1)               # [..., 2, 3]


def apply_similarity2d(m, pts) -> torch.Tensor:
    m = _f32(m)
    return (torch.einsum("...ij,...nj->...ni", m[..., :2], _f32(pts, m))
            + m[..., None, :, 2])


def fit_affine_segmented(src, dst, seg, n_seg: int,
                         weights) -> torch.Tensor:
    """`fit_affine` of n_seg point sets held as one flat list: src/dst
    [M, 2] (float32), seg [M] the set of each point, weights [M] ->
    float32 [n_seg, 2, 3]. The normal equations' weighted sums are taken
    and solved in float64, the model rounded to float32 once: the sums do
    not depend on the points' order, and a set of one or two points, whose
    system is singular but for the 1e-6 regularisation, gets its
    regularised solution, where `fit_affine`'s float32 solve, which cannot
    resolve 1e-6 beside sums of ~1e6, returns rounding noise. Wherever the
    system is well determined the two agree to float32 rounding. A set
    with no weight gives the zero model."""
    src = _f32(src)
    dst = _f32(dst, src)
    seg = torch.as_tensor(seg, device=src.device).long()
    x = torch.cat([src, torch.ones_like(src[:, :1])], -1).double()
    xw = x * _f32(weights, src).double()[:, None]
    sums = torch.zeros((n_seg, 3, 5), dtype=torch.float64,
                       device=src.device).index_add_(
        0, seg, xw[:, :, None] * torch.cat([x, dst.double()], -1)[:, None])
    eye = torch.eye(3, dtype=torch.float64, device=src.device) * 1e-6
    sol = torch.linalg.solve_ex(sums[..., :3] + eye, sums[..., 3:])[0]
    return sol.mT.float()
