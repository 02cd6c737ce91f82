"""DoG keypoint detection: 3x3x3 extrema, edge rejection, subpixel fit
(counterpart of `cvt_tpu.features.detect`).

Reference behavior: VLFeat sift/covdet detection as configured by
covdet/vl_covdet.hpp:79-88 (peakThreshold, edgeThreshold=10, boundary
margin drop at :150-156) and sift.h:59-84 (peak_threshold 0.02/3).

The extrema tests are two 3x3x3 max-pools over the whole [B, L, H, W]
stack; candidates are the top-K by response magnitude in
`jax.lax.top_k`'s tie order (`ops/topk.top_k_largest`: which slots fill
the K when fewer than K positions qualify depends on it), fixed K slots
plus a validity mask; the 3-D quadratic fit solves a closed-form 3x3
system on gathered neighbourhoods only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cvt_tpu_torch.ops.topk import top_k_largest


class Keypoints(NamedTuple):
    """Fixed-size keypoint set for one octave (or merged).
    x, y: [B, K] input-image coordinates; sigma: [B, K] scale in input
    pixels; level: [B, K] int64 pyramid level; response: [B, K] DoG value;
    valid: [B, K] bool."""
    x: torch.Tensor
    y: torch.Tensor
    sigma: torch.Tensor
    level: torch.Tensor
    response: torch.Tensor
    valid: torch.Tensor


def _window_max(d: torch.Tensor) -> torch.Tensor:
    """3x3x3 maximum over (level, y, x), -inf beyond the borders."""
    return F.max_pool3d(d[:, None], 3, stride=1, padding=1)[:, 0]


def _window_min(d: torch.Tensor) -> torch.Tensor:
    return -_window_max(-d)


def _roll2(g, sy: int, sx: int):
    return torch.roll(g, (sy, sx), (2, 3))


def _second_derivatives(g: torch.Tensor):
    """Central second differences of [B, L, H, W] along x, y and xy,
    wrapping at the borders (jnp.roll)."""
    lxx = torch.roll(g, -1, 3) + torch.roll(g, 1, 3) - 2 * g
    lyy = torch.roll(g, -1, 2) + torch.roll(g, 1, 2) - 2 * g
    lxy = 0.25 * (_roll2(g, -1, -1) + _roll2(g, 1, 1)
                  - _roll2(g, -1, 1) - _roll2(g, 1, -1))
    return lxx, lyy, lxy


def hessian_response(gauss: torch.Tensor, n_scales: int = 3,
                     sigma0: float = 1.6) -> torch.Tensor:
    """Scale-normalized determinant-of-Hessian response stack.

    The reference covdet's DEFAULT detector (vl_covdet.hpp:73-88,
    VL_COVDET_METHOD_HESSIAN; VLFeat covdet.c _vl_det_hessian_response):
    R = sigma^4 * (Lxx * Lyy - Lxy^2) per Gaussian level. gauss
    [B, L, H, W] (octave levels); sigma in octave pixels per level.
    """
    lxx, lyy, lxy = _second_derivatives(gauss)
    resp = lxx * lyy - lxy * lxy
    lvl = torch.arange(gauss.shape[1], dtype=torch.float32)
    sig = (sigma0 * (2.0 ** (lvl / float(n_scales)))) ** 4
    return resp * sig.to(gauss.device)[None, :, None, None]


def detect_octave(dog: torch.Tensor, *, max_k: int,
                  peak_threshold: float = 0.02 / 3,
                  edge_threshold: float = 10.0, border: int = 4):
    """Response stack [B, L, H, W] (DoG or Hessian) -> per-octave
    keypoints in OCTAVE coordinates.

    Returns (x, y, level_f, level, response, valid): x/y/level_f are
    subpixel-refined floats, level the integer level (int64), all
    [B, max_k]; valid marks real detections.
    """
    b, l, h, w = dog.shape
    dev = dog.device

    is_max = (dog >= _window_max(dog)) & (dog > peak_threshold)
    is_min = (dog <= _window_min(dog)) & (dog < -peak_threshold)
    extremum = is_max | is_min

    # edge rejection: spatial Hessian ratio (Lowe; vl_sift.c update_*)
    dxx, dyy, dxy = _second_derivatives(dog)
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)

    # borders: levels 0 and L-1 and image margins are invalid
    inb = torch.zeros((l, h, w), dtype=torch.bool, device=dev)
    inb[1:l - 1, border:h - border, border:w - border] = True

    ok = extremum & edge_ok & inb
    score = torch.where(ok, torch.abs(dog), 0.0).reshape(b, -1)
    # small octaves can hold fewer candidate positions than max_k: select
    # what exists, then pad invalid slots to a fixed [B, max_k]
    k_eff = min(max_k, score.shape[1])
    topv, topi = top_k_largest(score, k_eff)                     # [B, K]
    if k_eff < max_k:
        pad = max_k - k_eff
        topv = F.pad(topv, (0, pad))
        # padded slots point at an interior position (level 1, (1, 1));
        # valid=False masks them everywhere downstream
        topi = F.pad(topi, (0, pad), value=h * w + w + 1)
    valid = topv > 0.0
    lev_i = topi // (h * w)
    rem = topi % (h * w)
    y_i = rem // w
    x_i = rem % w

    # ---- subpixel refinement on gathered 3x3x3 neighborhoods -----------
    # the window starts one before the centre, clamped into the stack as
    # lax.dynamic_slice clamps it
    l0 = torch.clamp(lev_i - 1, 0, l - 3)
    y0 = torch.clamp(y_i - 1, 0, h - 3)
    x0 = torch.clamp(x_i - 1, 0, w - 3)
    o = torch.arange(3, device=dev)
    offs = ((o[:, None, None] * h + o[None, :, None]) * w
            + o[None, None, :]).reshape(-1)                      # [27]
    start = (l0 * h + y0) * w + x0
    p = torch.gather(dog.reshape(b, -1), 1,
                     (start[..., None] + offs).reshape(b, -1))
    p = p.reshape(b, max_k, 3, 3, 3)                             # [B,K,3,3,3]

    g = torch.stack([
        0.5 * (p[..., 1, 1, 2] - p[..., 1, 1, 0]),   # d/dx
        0.5 * (p[..., 1, 2, 1] - p[..., 1, 0, 1]),   # d/dy
        0.5 * (p[..., 2, 1, 1] - p[..., 0, 1, 1]),   # d/ds
    ], -1)                                                       # [B,K,3]
    hxx = p[..., 1, 1, 2] + p[..., 1, 1, 0] - 2 * p[..., 1, 1, 1]
    hyy = p[..., 1, 2, 1] + p[..., 1, 0, 1] - 2 * p[..., 1, 1, 1]
    hss = p[..., 2, 1, 1] + p[..., 0, 1, 1] - 2 * p[..., 1, 1, 1]
    hxy = 0.25 * (p[..., 1, 2, 2] - p[..., 1, 2, 0]
                  - p[..., 1, 0, 2] + p[..., 1, 0, 0])
    hxs = 0.25 * (p[..., 2, 1, 2] - p[..., 2, 1, 0]
                  - p[..., 0, 1, 2] + p[..., 0, 1, 0])
    hys = 0.25 * (p[..., 2, 2, 1] - p[..., 2, 0, 1]
                  - p[..., 0, 2, 1] + p[..., 0, 0, 1])
    # closed-form symmetric 3x3 solve (adjugate/Cramer)
    a00 = hxx + 1e-6
    a11 = hyy + 1e-6
    a22 = hss + 1e-6
    c00 = a11 * a22 - hys * hys
    c01 = hxs * hys - hxy * a22
    c02 = hxy * hys - hxs * a11
    c11 = a00 * a22 - hxs * hxs
    c12 = hxy * hxs - a00 * hys
    c22 = a00 * a11 - hxy * hxy
    det = a00 * c00 + hxy * c01 + hxs * c02
    inv_det = torch.where(torch.abs(det) > 1e-20, 1.0 / det, 0.0)
    gx_, gy_, gs_ = g[..., 0], g[..., 1], g[..., 2]
    off = -inv_det[..., None] * torch.stack([
        c00 * gx_ + c01 * gy_ + c02 * gs_,
        c01 * gx_ + c11 * gy_ + c12 * gs_,
        c02 * gx_ + c12 * gy_ + c22 * gs_,
    ], -1)                                                       # [B,K,3]
    off = torch.clamp(off, -1.0, 1.0)   # reject divergent fits conservatively

    x_f = x_i.to(torch.float32) + off[..., 0]
    y_f = y_i.to(torch.float32) + off[..., 1]
    l_f = lev_i.to(torch.float32) + off[..., 2]
    resp = p[..., 1, 1, 1] + 0.5 * torch.sum(g * off, -1)
    return x_f, y_f, l_f, lev_i, resp, valid
