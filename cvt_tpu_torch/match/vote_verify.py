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

`vote_and_verify_segmented` runs the same maths over many match sets of
uneven sizes held as one flat list (a batch of verified image pairs),
with no padding.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from cvt_tpu_torch.match.solvers import (_f32, apply_affine, fit_affine,
                                         fit_affine_segmented)
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


def _vote_bins(f1, f2, image_extent: float, bins_t: int, bins_s: int,
               bins_r: int) -> torch.Tensor:
    """Each match's finest Hough bin [...] (int64): the similarity that
    carries frame f1 onto f2 (TransformFromMatch, geometry.cc), quantized
    into the 4-D histogram."""
    ds = torch.log2((f2[..., 2] + 1e-6) / (f1[..., 2] + 1e-6))
    dr = f2[..., 3] - f1[..., 3]
    dr = torch.atan2(torch.sin(dr), torch.cos(dr))       # wrap to [-pi, pi]
    s = torch.pow(2.0, ds)
    ca, sa = torch.cos(dr), torch.sin(dr)
    tx = f2[..., 0] - s * (ca * f1[..., 0] - sa * f1[..., 1])
    ty = f2[..., 1] - s * (sa * f1[..., 0] + ca * f1[..., 1])
    bt = _bin((tx / (2 * image_extent) + 0.5) * bins_t, bins_t)
    bty = _bin((ty / (2 * image_extent) + 0.5) * bins_t, bins_t)
    bs = _bin((ds / 8.0 + 0.5) * bins_s, bins_s)
    br = _bin((dr / (2 * np.pi) + 0.5) * bins_r, bins_r)
    return ((bt * bins_t + bty) * bins_s + bs) * bins_r + br


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

    flat_bin = _vote_bins(f1, f2, image_extent, bins_t, bins_s, bins_r)
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


@lru_cache(maxsize=8)
def _level_maps(bins_t: int, bins_s: int, bins_r: int, n_levels: int,
                device: torch.device) -> torch.Tensor:
    """[n_levels, n_bins] on `device`: row 0 each finest bin itself, row l
    its level-l parent (`_parent_maps`). Shared by every caller of the
    cache: read it only."""
    first = torch.arange(bins_t * bins_t * bins_s * bins_r)
    return torch.stack([first, *_parent_maps(bins_t, bins_s, bins_r,
                                              n_levels)]).to(device)


def _run_counts(key: torch.Tensor) -> torch.Tensor:
    """For each element of key (int64, any shape), how many elements hold
    its value (one sort; no host sync)."""
    srt, order = torch.sort(key.reshape(-1))
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    run = torch.cumsum(new, 0) - 1
    n = torch.zeros_like(srt).index_add_(0, run, torch.ones_like(srt))
    out = torch.empty_like(srt)
    out[order] = n[run]
    return out.reshape(key.shape)


def _inliers(a, f1, f2, threshold: float,
             max_scale_error: float) -> torch.Tensor:
    """The two-way transfer and scale test of `vote_and_verify`: models a
    [..., 2, 3] against matches f1 -> f2 [..., 4], broadcast."""
    x, y = f1[..., 0], f1[..., 1]
    dx = (a[..., 0, 0] * x + a[..., 0, 1] * y) + a[..., 0, 2] - f2[..., 0]
    dy = (a[..., 1, 0] * x + a[..., 1, 1] * y) + a[..., 1, 2] - f2[..., 1]
    det = torch.abs(a[..., 0, 0] * a[..., 1, 1]
                    - a[..., 0, 1] * a[..., 1, 0])
    area_t = f1[..., 2] ** 2 * torch.clamp_min(det, 1e-12)
    area_m = f2[..., 2] ** 2 + 1e-12
    ratio = torch.maximum(area_t / area_m, area_m / area_t)
    return ((dx * dx + dy * dy < threshold * threshold)
            & (ratio <= max_scale_error * max_scale_error))


def _count(seg, n_seg: int, flags) -> torch.Tensor:
    """Per set, how many of its elements' flags [M] (or [M, S]) are set."""
    return torch.zeros((n_seg,) + flags.shape[1:], dtype=torch.int64,
                       device=seg.device).index_add_(0, seg, flags.long())


def _bin_ranks(seg, flat_bin, score, n_seg: int, n_bins: int,
               span: int) -> torch.Tensor:
    """Each match's bin's place [M] among its set's occupied bins ordered
    by pyramid score (descending, scores below `span`), then bin (the
    order of `top_k_largest` over the padded form's bins)."""
    key = (seg * span + (span - 1 - score)) * n_bins + flat_bin
    srt, order = torch.sort(key)
    new_bin = torch.ones_like(srt, dtype=torch.bool)
    new_bin[1:] = srt[1:] != srt[:-1]
    seg_s = seg[order]
    bin_no = torch.cumsum(new_bin, 0) - 1
    first = torch.full((n_seg,), span * n_bins, dtype=torch.int64,
                       device=seg.device).scatter_reduce(
        0, seg_s, bin_no, "amin")
    out = torch.empty_like(bin_no)
    out[order] = bin_no - first[seg_s]
    return out


def vote_and_verify_segmented(frames1, frames2, seg, n_seg: int, *,
                              image_extent: float = 1024.0,
                              bins_t: int = 16, bins_s: int = 8,
                              bins_r: int = 8, n_seeds: int = 8,
                              threshold: float = 8.0, n_levels: int = 6,
                              max_scale_error: float = 2.0,
                              eff_bins: int = 64) -> VoteVerifyResult:
    """`vote_and_verify` of n_seg match sets held as one flat list:
    frames1/frames2 [M, 4], seg [M] the set of each match, in any order;
    every match counts (no `valid`). -> score, model, n_inliers [n_seg]
    and inliers [M].

    The same maths set by set, with no padding and no [..., n_bins]
    tensor: a bin's pyramid score is counted from the matches' keys
    (sorts), as an integer 2^(n_levels-1) times the padded form's exact
    float score; the seeds are each set's first n_seeds occupied bins in
    the padded form's order. A seed beyond a set's occupied bins holds no
    vote, so its support is 0 and it is never the best there: such slots
    fit an empty model. Counts, minima and maxima do not depend on the
    matches' order. The affine fits are summed and solved in float64
    (`fit_affine_segmented`), where the padded form sums and solves in
    float32: where a fit is well determined the two agree to float32
    rounding (a match at an inlier threshold may fall the other way);
    where a seed bin holds one or two matches, the padded form's model is
    float32 rounding noise and this form's the regularised solution, and
    the few inliers either carries may differ."""
    f1 = _f32(frames1)
    dev = f1.device
    f2 = _f32(frames2, f1)
    seg = torch.as_tensor(seg, device=dev).long()
    m = seg.shape[0]
    n_bins = bins_t * bins_t * bins_s * bins_r
    flat_bin = _vote_bins(f1, f2, image_extent, bins_t, bins_s, bins_r)

    # pyramid score of each match's bin (vote_and_verify.cc:294-318): its
    # set's votes in the bin and in each level's parent, counted at once
    top = 1 << (n_levels - 1)
    level = torch.arange(n_levels, device=dev)
    cells = _level_maps(bins_t, bins_s, bins_r, n_levels, dev)[:, flat_bin]
    votes_at = _run_counts((level[:, None] * n_seg + seg) * n_bins + cells)
    score = torch.sum(votes_at * (top >> level)[:, None], 0)
    span = (2 * top - 1) * m + 1
    if n_seg * span * n_bins >= 2 ** 63:
        raise ValueError("vote_and_verify_segmented: too many matches for "
                         "the int64 ranking key")
    rank = _bin_ranks(seg, flat_bin, score, n_seg, n_bins, span)

    # the seed bins fit an affine each (matches beyond a set's seeds fall
    # in its last slot with weight 0)
    is_seed = rank < n_seeds
    slot = seg * n_seeds + rank.clamp_max(n_seeds - 1)
    models = fit_affine_segmented(f1[:, :2], f2[:, :2], slot,
                                  n_seg * n_seeds, is_seed).reshape(
        n_seg, n_seeds, 2, 3)
    votes = _count(slot, n_seg * n_seeds, is_seed).reshape(n_seg, n_seeds)
    inl = _inliers(models[seg], f1[:, None], f2[:, None], threshold,
                   max_scale_error)                           # [M, S]
    support = _count(seg, n_seg, inl)
    finite = torch.all(torch.isfinite(models.flatten(-2)), -1)
    support = torch.where(finite & (votes >= 3), support, 0)
    best = torch.argmax(support, -1)                           # first max

    # the LO step on the winning inlier set (vote_and_verify.cc:379-397)
    inl_best = torch.gather(inl, 1, best[seg][:, None])[:, 0]
    model2 = fit_affine_segmented(f1[:, :2], f2[:, :2], seg, n_seg,
                                  inl_best)
    inl2 = _inliers(model2[seg], f1, f2, threshold, max_scale_error)
    ok2 = (torch.all(torch.isfinite(model2.flatten(-2)), -1)
           & (_count(seg, n_seg, inl_best) >= 3))
    better = (_count(seg, n_seg, inl2)
              >= torch.gather(support, 1, best[:, None])[:, 0]) & ok2
    model_best = models[torch.arange(n_seg, device=dev), best]
    model = torch.where(better[:, None, None], model2, model_best)
    inliers = torch.where(better[seg], inl2, inl_best)
    n_inl = _count(seg, n_seg, inliers)

    # effective inlier count (vote_and_verify.cc:152-204): the occupied
    # cells of an eff_bins x eff_bins grid over each set's inliers' box
    x1, y1 = f1[:, 0], f1[:, 1]
    inf = float("inf")
    box = []
    for v, fill, how in ((x1, inf, "amin"), (x1, -inf, "amax"),
                         (y1, inf, "amin"), (y1, -inf, "amax")):
        box.append(torch.full((n_seg,), fill, device=dev).scatter_reduce(
            0, seg, torch.where(inliers, v, fill), how))
    min_x, max_x, min_y, max_y = box
    sx = eff_bins / torch.clamp_min(max_x - min_x, 1e-6)
    sy = eff_bins / torch.clamp_min(max_y - min_y, 1e-6)
    cell = (_bin((x1 - min_x[seg]) * sx[seg], eff_bins) * eff_bins
            + _bin((y1 - min_y[seg]) * sy[seg], eff_bins))
    n_cells = eff_bins * eff_bins
    key = torch.where(inliers, seg * n_cells + cell, n_seg * n_cells)
    srt = torch.sort(key).values
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    occupied = _count(srt.clamp_max(n_seg * n_cells - 1) // n_cells, n_seg,
                      new & (srt < n_seg * n_cells))
    eff = torch.where(n_inl > 0, occupied.to(torch.float32), 0.0)
    return VoteVerifyResult(score=eff, model=model, inliers=inliers,
                            n_inliers=n_inl.to(torch.float32))
