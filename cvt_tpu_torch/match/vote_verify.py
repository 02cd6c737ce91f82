"""Vote-and-verify: multi-resolution Hough voting + affine refit
(counterpart of `cvt_tpu.match.vote_verify`).

Reference: retrieval/vlindex/src/retrieval/vote_and_verify.cc. Each match
votes for a 4-D similarity (tx, ty, log sigma, theta) into a 6-level
multi-resolution Hough pyramid (:238-288); occupied finest bins score
their own votes plus 0.5^l-weighted parent votes (:294-318); the top bins
seed affine refits whose inliers pass both the transfer error and the
scale-consistency test (ComputeInliers :173-189, ComputeScaleError
:104-115); the score is the effective inlier count, the occupied cells of
a 64x64 grid over the inliers (ComputeEffectiveInlierCount :152-204).

Leading batch dimensions stand in for `jax.vmap`: frames [..., N, 4]
verify every candidate of a batch in one call. Votes are 0/1, so the
scatter-added histograms are exact in any order and the pyramid scores
equal `cvt_tpu`'s bitwise; the seeds come from `top_k_largest`, whose tie
order (lower bin first) is `lax.top_k`'s.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from cvt_tpu_torch.match.solvers import _f32, apply_affine, fit_affine
from cvt_tpu_torch.ops.topk import top_k_largest


class VoteVerifyResult(NamedTuple):
    score: torch.Tensor       # [...]: effective inlier count of best model
    model: torch.Tensor       # [..., 2, 3] affine
    inliers: torch.Tensor     # [..., N] bool
    n_inliers: torch.Tensor   # [...]: raw inlier count


@lru_cache(maxsize=8)
def _parent_maps(bins_t: int, bins_s: int, bins_r: int,
                 n_levels: int) -> tuple:
    """Parent flat-index maps per pyramid level: level-0 flat bin -> flat
    index formed from right-shifted coordinates with the same strides
    (the reference's index formula, vote_and_verify.cc:270-283). CPU
    tensors, shared by every caller of the cache: read them only."""
    a = np.arange(bins_t * bins_t * bins_s * bins_r)
    br = a % bins_r
    rest = a // bins_r
    bs = rest % bins_s
    rest //= bins_s
    bty = rest % bins_t
    bt = rest // bins_t
    maps = []
    for lvl in range(1, n_levels):
        t1, t2 = bt >> lvl, bty >> lvl
        s1, r1 = bs >> lvl, br >> lvl
        maps.append(torch.from_numpy(
            ((t1 * bins_t + t2) * bins_s + s1) * bins_r + r1))
    return tuple(maps)


def _bin(v: torch.Tensor, hi: int) -> torch.Tensor:
    """Truncate toward zero to int and clip to [0, hi - 1], as `cvt_tpu`'s
    astype(int32) + clip does; NaN gives 0 and +-inf saturate, as XLA's
    conversion does."""
    v = torch.nan_to_num(v, nan=0.0).clamp(-1.0, float(hi))
    return v.to(torch.int32).clamp(0, hi - 1).long()


def vote_and_verify(frames1, frames2, valid=None, *,
                    image_extent: float = 1024.0, bins_t: int = 16,
                    bins_s: int = 8, bins_r: int = 8, n_seeds: int = 8,
                    threshold: float = 8.0, n_levels: int = 6,
                    max_scale_error: float = 2.0,
                    eff_bins: int = 64) -> VoteVerifyResult:
    """frames1/frames2 [..., N, 4] matched (x, y, sigma, angle) keypoint
    frames, valid [..., N]; each match votes for a similarity transform
    into a multi-resolution pyramid; the best-scored bins seed affine
    refits; the best refit's effective inlier count (64x64 grid) is the
    score. Tensors keep their device; numpy goes to the card."""
    f1 = _f32(frames1)
    f2 = _f32(frames2, f1)
    lead, n = f1.shape[:-2], f1.shape[-2]
    if valid is None:
        valid = torch.ones(lead + (n,), dtype=torch.bool, device=f1.device)
    valid = torch.as_tensor(valid, device=f1.device).to(torch.bool)

    # per-match similarity parameters (TransformFromMatch, geometry.cc)
    ds = torch.log2((f2[..., 2] + 1e-6) / (f1[..., 2] + 1e-6))
    dr = f2[..., 3] - f1[..., 3]
    dr = torch.atan2(torch.sin(dr), torch.cos(dr))       # wrap to [-pi, pi]
    s = torch.pow(2.0, ds)
    ca, sa = torch.cos(dr), torch.sin(dr)
    tx = f2[..., 0] - s * (ca * f1[..., 0] - sa * f1[..., 1])
    ty = f2[..., 1] - s * (sa * f1[..., 0] + ca * f1[..., 1])

    # quantize into the finest 4-D histogram
    bt = _bin((tx / (2 * image_extent) + 0.5) * bins_t, bins_t)
    bty = _bin((ty / (2 * image_extent) + 0.5) * bins_t, bins_t)
    bs = _bin((ds / 8.0 + 0.5) * bins_s, bins_s)
    br = _bin((dr / (2 * np.pi) + 0.5) * bins_r, bins_r)
    flat_bin = ((bt * bins_t + bty) * bins_s + bs) * bins_r + br   # [..., N]
    n_bins = bins_t * bins_t * bins_s * bins_r
    vote = valid.to(torch.float32)
    zeros = torch.zeros(lead + (n_bins,), dtype=torch.float32,
                        device=f1.device)
    hist = zeros.scatter_add(-1, flat_bin, vote)

    # multi-resolution pyramid score (vote_and_verify.cc:294-318):
    # score(bin) = votes(bin) + sum_l 0.5^l * votes(parent_l(bin))
    score_arr = hist
    weight = 0.5
    for pm in _parent_maps(bins_t, bins_s, bins_r, n_levels):
        pm = pm.to(f1.device)
        hist_l = zeros.scatter_add(-1, pm[flat_bin], vote)
        score_arr = score_arr + weight * hist_l[..., pm]
        weight *= 0.5
    # only occupied finest bins compete
    score_arr = torch.where(hist > 0, score_arr, -1.0)

    # top bins seed refits: matches voting into a seed bin fit an affine
    _, top_bins = top_k_largest(score_arr, n_seeds)            # [..., S]
    in_bin = ((flat_bin[..., None, :] == top_bins[..., :, None])
              & valid[..., None, :])
    w = in_bin.to(torch.float32)                               # [..., S, N]
    p1, p2 = f1[..., :2], f2[..., :2]
    models = fit_affine(p1[..., None, :, :].expand(w.shape + (2,)),
                        p2[..., None, :, :].expand(w.shape + (2,)), w)

    def model_inliers(model, extra: int):
        """Two-way transfer + scale-consistency inlier test for models
        [..., (S,) 2, 3] (`extra` = 1 with the seed axis)."""
        g1, g2, v = f1, f2, valid
        if extra:
            g1, g2, v = f1[..., None, :, :], f2[..., None, :, :], \
                valid[..., None, :]
        res2 = torch.sum((apply_affine(model, g1[..., :2]) - g2[..., :2])
                         ** 2, -1)
        det = torch.abs(model[..., 0, 0] * model[..., 1, 1]
                        - model[..., 0, 1] * model[..., 1, 0])
        area_t = g1[..., 2] ** 2 * torch.clamp_min(det, 1e-12)[..., None]
        area_m = g2[..., 2] ** 2 + 1e-12
        ratio = torch.maximum(area_t / area_m, area_m / area_t)
        return ((res2 < threshold * threshold)
                & (ratio <= max_scale_error * max_scale_error) & v)

    inl = model_inliers(models, 1)                             # [..., S, N]
    support = torch.sum(inl, -1)
    finite = torch.all(torch.isfinite(models.flatten(-2)), -1)
    support = torch.where(finite & (torch.sum(w, -1) >= 3), support, 0)
    best = torch.argmax(support, -1, keepdim=True)             # first max

    # one more refit on the winning inlier set (the LO step,
    # vote_and_verify.cc:379-397)
    inl_best = torch.gather(inl, -2, best[..., None].expand(
        lead + (1, n)))[..., 0, :]
    w2 = inl_best.to(torch.float32)
    model2 = fit_affine(p1, p2, w2)
    inl2 = model_inliers(model2, 0)
    ok2 = (torch.all(torch.isfinite(model2.flatten(-2)), -1)
           & (torch.sum(w2, -1) >= 3))
    better = (torch.sum(inl2, -1) >= torch.gather(support, -1,
                                                  best)[..., 0]) & ok2
    model_best = torch.gather(models, -3, best[..., None, None].expand(
        lead + (1, 2, 3)))[..., 0, :, :]
    model = torch.where(better[..., None, None], model2, model_best)
    inliers = torch.where(better[..., None], inl2, inl_best)
    n_inl = torch.sum(inliers, -1)

    # effective inlier count (vote_and_verify.cc:152-204): occupied cells
    # of an eff_bins x eff_bins grid over the inliers' bounding box in
    # image 1; co-located (bursty) inliers count once
    x1, y1 = f1[..., 0], f1[..., 1]
    inf = float("inf")
    min_x = torch.where(inliers, x1, inf).amin(-1, keepdim=True)
    max_x = torch.where(inliers, x1, -inf).amax(-1, keepdim=True)
    min_y = torch.where(inliers, y1, inf).amin(-1, keepdim=True)
    max_y = torch.where(inliers, y1, -inf).amax(-1, keepdim=True)
    sx = eff_bins / torch.clamp_min(max_x - min_x, 1e-6)
    sy = eff_bins / torch.clamp_min(max_y - min_y, 1e-6)
    cell = (_bin((x1 - min_x) * sx, eff_bins) * eff_bins
            + _bin((y1 - min_y) * sy, eff_bins))
    occ = torch.zeros(lead + (eff_bins * eff_bins,), dtype=torch.float32,
                      device=f1.device).scatter_reduce(
        -1, cell, inliers.to(torch.float32), "amax")
    eff = torch.where(n_inl > 0, torch.sum(occ, -1), 0.0)
    return VoteVerifyResult(score=eff, model=model, inliers=inliers,
                            n_inliers=n_inl.to(torch.float32))
