"""Pupil tracking: Swirski-style coarse-to-fine pupil ellipse fit
(counterpart of `cvt_tpu.apps.pupil`).

Reference: detection_and_tracking/pupil_tracking — pupiltracker::
findPupilEllipse (src/pupil_tracker.cc, include/pupil_tracker.h:13-78):
1) specular-highlight erase, 2) Haar-like coarse pupil localization
(dark box vs bright surround response over a radius range), 3) intensity
-histogram threshold ("KMeans" split in the reference), 4) edge points +
RANSAC ellipse fit through a conic section (include/conic_section.h).

Every stage is batched over [B, H, W] eye crops:
  * specular erase = mask + box-blur infill (one "SAME" convolution),
  * the Haar search = two box means per radius from one integral image
    (a float32 double cumsum), argmax (the first maximum) over (y, x),
  * threshold = 64-bin histogram (an integer count) + between-class
    variance (Otsu-style split, the fixed-shape analogue of the
    reference's 2-means),
  * edge sampling = top-K gradient magnitudes inside the coarse ROI, by
    the tie-exact top-k (`ops/topk`; the magnitudes are small integers,
    so the tie order decides the sample),
  * ellipse fit = batched RANSAC: S five-point minimal conic solves
    scored by algebraic inlier count, the best of them the first maximum.

What differs from `cvt_tpu`:
  * sampling and fitting are split: `sample_edge_picks` draws each
    trial's 5 distinct edge points by a Gumbel top-k over the valid edges
    (`match/ransac.progressive_minimal_samples`, noise from a
    `torch.Generator`), which is what `jax.random.choice(replace=False,
    p=valid/sum)` computes but cannot equal its bits; `fit_pupil` takes
    the picks [B, S, 5], so it can be fed the picks JAX draws;
  * the minimal solve is `jnp.linalg.lstsq`'s: an SVD with JAX's cutoff
    eps·max(M, N) relative to the largest singular value, giving the
    minimum-norm solution of a degenerate sample (`torch.linalg.lstsq`
    on the card assumes full rank).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cvt_tpu_torch.match.ransac import progressive_minimal_samples
from cvt_tpu_torch.ops.linalg import full_precision_conv
from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.utils.device import resolve_device

RADII = (8, 12, 16, 24)


class PupilResult(NamedTuple):
    center: torch.Tensor      # [B, 2] (x, y)
    axes: torch.Tensor        # [B, 2] semi-axes (a, b)
    angle: torch.Tensor       # [B] radians
    conic: torch.Tensor       # [B, 6] (A, B, C, D, E, F)
    n_inliers: torch.Tensor   # [B] int32
    ok: torch.Tensor          # [B] bool


def _box_mean(ii: torch.Tensor, y0, x0, h, w) -> torch.Tensor:
    """Mean over [y0:y0+h, x0:x0+w) windows from an integral image
    ii [B, H+1, W+1], for index tensors of window positions [P] -> [B, P]."""
    s = (ii[:, y0 + h, x0 + w] - ii[:, y0, x0 + w]
         - ii[:, y0 + h, x0] + ii[:, y0, x0])
    return s / (h * w)


def _images(images, device) -> torch.Tensor:
    dev = resolve_device(device, like=images)
    return torch.as_tensor(images, dtype=torch.float32, device=dev)


def remove_specular(images, *, thresh: float = 0.9, blur: int = 7,
                    device=None) -> torch.Tensor:
    """Replace saturated highlights with a blurred infill
    (pupil_tracker.cc's specular erase + inpaint, shape-static)."""
    x = _images(images, device)
    k = torch.full((1, 1, blur, blur), 1.0 / (blur * blur),
                   dtype=torch.float32, device=x.device)
    lo = (blur - 1) // 2                               # XLA's "SAME"
    with full_precision_conv():
        sm = F.conv2d(F.pad(x[:, None],
                            (lo, blur - 1 - lo, lo, blur - 1 - lo)), k)[:, 0]
    return torch.where(x > thresh, sm, x)


def _haar_responses(x: torch.Tensor, radii):
    """Per radius that fits: (r, r2, ys, xs, response [B, P])."""
    b, h, w = x.shape
    ii = F.pad(torch.cumsum(torch.cumsum(x, 1), 2), (1, 0, 1, 0))
    out = []
    for r in radii:
        r2 = 3 * r
        if 2 * r2 >= min(h, w):
            continue
        yy, xx = torch.meshgrid(
            torch.arange(0, h - 2 * r2, device=x.device),
            torch.arange(0, w - 2 * r2, device=x.device), indexing="ij")
        yy, xx = yy.reshape(-1), xx.reshape(-1)
        inner = _box_mean(ii, yy + r2 - r, xx + r2 - r, 2 * r, 2 * r)
        outer = _box_mean(ii, yy, xx, 2 * r2, 2 * r2)
        out.append((r, r2, yy, xx, outer - inner))  # bright surround - dark
    return out


def coarse_pupil_center(images, radii: tuple[int, ...] = RADII, *,
                        device=None):
    """Haar-like dark-center/bright-surround search. Returns
    (center [B, 2] (x, y) float32, radius [B] float32)."""
    x = _images(images, device)
    b = x.shape[0]
    best_resp = torch.full((b,), -torch.inf, device=x.device)
    best_yx = torch.zeros((b, 2), dtype=torch.int64, device=x.device)
    best_r = torch.zeros((b,), dtype=torch.float32, device=x.device)
    for r, r2, yy, xx, resp in _haar_responses(x, radii):
        v, i = torch.max(resp, 1)                       # first maximum
        upd = v > best_resp
        best_resp = torch.where(upd, v, best_resp)
        best_yx = torch.where(upd[:, None],
                              torch.stack([yy[i] + r2, xx[i] + r2], -1),
                              best_yx)
        best_r = torch.where(upd, float(r), best_r)
    center_xy = torch.stack([best_yx[:, 1], best_yx[:, 0]], -1)
    return center_xy.to(torch.float32), best_r


def _otsu_threshold(x: torch.Tensor, mask: torch.Tensor, bins: int = 64):
    """Between-class-variance-maximizing split of masked pixels [B,H,W]
    (fixed-shape analogue of the reference's 2-means intensity split)."""
    b = x.shape[0]
    q = torch.clamp((x * (bins - 1)).to(torch.int64), 0, bins - 1)
    hist = torch.zeros((b, bins), dtype=torch.float32,
                       device=x.device).scatter_add_(
        1, q.reshape(b, -1), mask.reshape(b, -1).to(torch.float32))
    total = torch.clamp_min(hist.sum(-1, keepdim=True), 1.0)
    p = hist / total
    centers = (torch.arange(bins, device=x.device) + 0.5) / bins
    w0 = torch.cumsum(p, -1)
    mu = torch.cumsum(p * centers, -1)
    mu_t = mu[:, -1:]
    var_b = (mu_t * w0 - mu) ** 2 / (w0 * (1 - w0) + 1e-9)
    t = torch.argmax(var_b, -1)
    return (t.to(torch.float32) + 0.5) / bins              # [B]


def _lstsq(m: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.lstsq(m, rhs)[0]` batched: m [..., M, N], rhs [..., M]
    -> [..., N], the SVD solve with singular values below
    eps·max(M, N)·s_max dropped (the minimum-norm solution)."""
    u, s, vh = torch.linalg.svd(m, full_matrices=False)
    cutoff = torch.finfo(torch.float32).eps * max(m.shape[-2:])
    keep = s >= cutoff * s[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, s, 1.0), 0.0)
    utb = (u.transpose(-1, -2) @ rhs[..., None])[..., 0]
    return (vh.transpose(-1, -2) @ (s_inv * utb)[..., None])[..., 0]


def _conic_from_points(pts: torch.Tensor) -> torch.Tensor:
    """5-point minimal conic solve: A x2 + B xy + C y2 + D x + E y + F = 0
    with F = -1 normalization. pts [..., 5, 2] -> conic [..., 6]."""
    x, y = pts[..., 0], pts[..., 1]
    m = torch.stack([x * x, x * y, y * y, x, y], -1)        # [..., 5, 5]
    sol = _lstsq(m, torch.ones(m.shape[:-1], dtype=torch.float32,
                                device=m.device))
    return torch.cat([sol, torch.full(sol.shape[:-1] + (1,), -1.0,
                                      device=sol.device)], -1)


def _conic_residual(conic: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Normalized algebraic distance of points [..., K, 2] to conics
    [..., 6] -> [..., K]."""
    a, bb, c, d, e, f = (conic[..., i, None] for i in range(6))
    x, y = pts[..., 0], pts[..., 1]
    val = a * x * x + bb * x * y + c * y * y + d * x + e * y + f
    gx = 2 * a * x + bb * y + d
    gy = bb * x + 2 * c * y + e
    return torch.abs(val) / torch.sqrt(gx * gx + gy * gy + 1e-9)


def conic_to_ellipse(conic: torch.Tensor):
    """(A..F) [..., 6] -> center [..., 2], semi-axes [..., 2], angle
    [...]. Invalid conics give nan axes (caller checks `ok`)."""
    a, b2, c, d, e, f = (conic[..., i] for i in range(6))
    b = b2 / 2
    det = a * c - b * b
    cx = (b * (e / 2) - c * (d / 2)) / (det + 1e-12)
    cy = (b * (d / 2) - a * (e / 2)) / (det + 1e-12)
    # translate to center: constant term
    fc = f + (d / 2) * cx + (e / 2) * cy
    tr = a + c
    disc = torch.sqrt(torch.clamp_min((a - c) ** 2 + 4 * b * b, 0.0))
    l1 = (tr + disc) / 2
    l2 = (tr - disc) / 2
    ax1 = torch.sqrt(torch.clamp_min(-fc / (l2 + 1e-12), 0.0))
    ax2 = torch.sqrt(torch.clamp_min(-fc / (l1 + 1e-12), 0.0))
    angle = 0.5 * torch.atan2(2 * b, a - c)
    return torch.stack([cx, cy], -1), torch.stack([ax1, ax2], -1), angle


class PupilEdges(NamedTuple):
    """The fit's inputs: edge points normalized by the coarse center and
    radius (pn [B, K, 2]), which of them are edges (valid [B, K]), and
    the normalization (center [B, 2], scale [B])."""
    pn: torch.Tensor
    valid: torch.Tensor
    center: torch.Tensor
    scale: torch.Tensor


def pupil_edges(images, *, n_edge: int = 128,
                radii: tuple[int, ...] = RADII, device=None) -> PupilEdges:
    """Stages 1-3 and the edge sample of `find_pupil`."""
    x = remove_specular(_images(images, device))
    b, h, w = x.shape
    center, radius = coarse_pupil_center(x, radii)

    # ROI mask around the coarse center (3x the Haar radius)
    yy = torch.arange(h, device=x.device)[None, :, None]
    xx = torch.arange(w, device=x.device)[None, None, :]
    roi_r = (3.0 * radius)[:, None, None]
    roi = ((torch.abs(yy - center[:, 1][:, None, None]) < roi_r)
           & (torch.abs(xx - center[:, 0][:, None, None]) < roi_r))

    thresh = _otsu_threshold(x, roi)                          # [B]

    # gradient magnitude of the thresholded (dark) region boundary
    df = ((x < thresh[:, None, None]) & roi).to(torch.float32)
    gy = df[:, 2:, 1:-1] - df[:, :-2, 1:-1]
    gx = df[:, 1:-1, 2:] - df[:, 1:-1, :-2]
    mag = F.pad(torch.abs(gx) + torch.abs(gy), (1, 1, 1, 1))
    mag = torch.where(roi, mag, 0.0)

    # fixed-K edge sample: top-K gradient pixels, the lower index first
    val, idx = top_k_largest(mag.reshape(b, -1), n_edge)      # [B, K]
    pts = torch.stack([(idx % w).to(torch.float32),
                       (idx // w).to(torch.float32)], -1)     # [B, K, 2]
    scale = torch.clamp_min(radius, 1.0)
    pn = (pts - center[:, None, :]) / scale[:, None, None]
    return PupilEdges(pn=pn, valid=val > 0, center=center, scale=scale)


def sample_edge_picks(gen: torch.Generator | None, valid: torch.Tensor,
                      n_trials: int = 64) -> torch.Tensor:
    """Each trial's 5 distinct edge points, uniform over the valid ones
    (`jax.random.choice(n_edge, (5,), replace=False, p=valid/sum)`'s
    distribution): valid [B, K] -> picks [B, n_trials, 5] int64. gen
    None means seed 0."""
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    return progressive_minimal_samples(gen, n_trials, 5, valid)


def fit_pupil(edges: PupilEdges, picks: torch.Tensor, *,
              inlier_tol: float = 1.5,
              min_inliers: int = 24) -> PupilResult:
    """The RANSAC ellipse fit on the given picks [B, S, 5]: every trial's
    conic scored on all edges, the first trial of most inliers kept."""
    pn, valid = edges.pn, edges.valid
    b, s = picks.shape[:2]
    sel = torch.gather(pn[:, None].expand(-1, s, -1, -1), 2,
                       picks[..., None].expand(-1, -1, -1, 2))
    conics = _conic_from_points(sel)                          # [B, S, 6]
    res = _conic_residual(conics, pn[:, None])                # [B, S, K]
    scores = torch.sum((res < inlier_tol / 16.0) & valid[:, None], -1)
    score, best = torch.max(scores, 1)                        # first max
    conic_n = conics[torch.arange(b, device=pn.device), best]
    cen_n, axes_n, angle = conic_to_ellipse(conic_n)
    cen = cen_n * edges.scale[:, None] + edges.center
    axes = axes_n * edges.scale[:, None]
    ok = ((score >= min_inliers) & torch.all(torch.isfinite(axes), -1)
          & (axes[:, 0] > 1.0))
    return PupilResult(center=cen, axes=axes, angle=angle, conic=conic_n,
                       n_inliers=score.to(torch.int32), ok=ok)


def find_pupil(gen, images, *, n_edge: int = 128, n_trials: int = 64,
               inlier_tol: float = 1.5, min_inliers: int = 24,
               radii: tuple[int, ...] = RADII,
               device=None) -> PupilResult:
    """Batched pupil ellipse detection on [B, H, W] gray crops in [0,1].
    gen: a torch.Generator for the RANSAC samples (None: seed 0). A
    tensor keeps its device; numpy goes to `device` (default the card)."""
    edges = pupil_edges(images, n_edge=n_edge, radii=radii, device=device)
    picks = sample_edge_picks(gen, edges.valid, n_trials)
    return fit_pupil(edges, picks, inlier_tol=inlier_tol,
                     min_inliers=min_inliers)


def render_eye(h: int = 96, w: int = 128, cx: float = 64.0, cy: float = 48.0,
               a: float = 14.0, b: float = 10.0, angle: float = 0.3,
               iris_r: float = 30.0, specular: bool = True) -> np.ndarray:
    """Synthetic eye crop for tests/demos: bright sclera, mid iris, dark
    elliptical pupil, optional specular dot."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ca, sa = np.cos(angle), np.sin(angle)
    u = (xx - cx) * ca + (yy - cy) * sa
    v = -(xx - cx) * sa + (yy - cy) * ca
    img = np.full((h, w), 0.85, np.float32)
    ir = (xx - cx) ** 2 + (yy - cy) ** 2 < iris_r ** 2
    img[ir] = 0.45
    pup = (u / a) ** 2 + (v / b) ** 2 < 1.0
    img[pup] = 0.05
    if specular:
        sp = (xx - cx - 3) ** 2 + (yy - cy - 2) ** 2 < 4
        img[sp] = 1.0
    return img
