"""Batched RANSAC with local optimization (LO) refit (counterpart of
`cvt_tpu.match.ransac`).

Reference: vlindex `RANSAC<Estimator,SupportMeasurer,Sampler>` — the
sequential adaptive-trial loop (optim/ransac.h:184-259, trial bound
:159-169) and `LORANSAC` (optim/loransac.h:54).

Instead of a sequential loop with a data-dependent stopping rule, S
hypotheses are drawn at once, solved as one batched minimal-solver call
and scored on all S x N residuals; the best support is LO-refit on its
inliers. Every function takes leading batch dims (candidate images), so
one call verifies many problems. Random draws come from a
`torch.Generator` (Gumbel noise on the generator's device, then moved to
the points' device: the same seed draws the same samples on the CPU and
the card); they cannot match `jax.random`'s bits.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

from cvt_tpu_torch.match.solvers import (
    _f32, apply_affine, apply_homography, apply_similarity2d,
    apply_translation, fit_affine, fit_homography_dlt, fit_similarity2d,
    fit_translation)
from cvt_tpu_torch.ops.topk import top_k_largest

_MODELS = {
    "affine": dict(min_n=3, fit=fit_affine, apply=apply_affine),
    "homography": dict(min_n=4, fit=fit_homography_dlt,
                       apply=apply_homography),
    # translation_transform.h / similarity at 2-D
    "translation": dict(min_n=1, fit=fit_translation,
                        apply=apply_translation),
    "similarity": dict(min_n=2, fit=fit_similarity2d,
                       apply=apply_similarity2d),
}


def _gumbel(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise of `shape` drawn from `gen` on its own device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    u = torch.clamp(u, torch.finfo(torch.float32).tiny, 1.0)
    return (-torch.log(-torch.log(u))).to(device)


def progressive_minimal_samples(gen: torch.Generator, n_hypotheses: int,
                                mn: int, valid, scores=None):
    """PROSAC-style batched minimal-set sampling (reference:
    optim/sampler/progressive_sampler.cc): hypothesis j draws its
    minimal set from the T_j TOP-RANKED correspondences, with T_j
    ramping from ~2*mn up to all N — early hypotheses concentrate on
    confident matches, late ones recover the uniform sampler.

    The sequential growth-function loop becomes one Gumbel top-k with a
    per-hypothesis rank cutoff. valid [..., N] -> picks [..., S, mn]
    int64. scores: higher = more confident (None = uniform over
    valid)."""
    n = valid.shape[-1]
    dev = valid.device
    g = _gumbel(gen, valid.shape[:-1] + (n_hypotheses, n), dev)
    if scores is None:
        logits = torch.where(valid, 0.0, -math.inf)
        return top_k_largest(g + logits[..., None, :], mn)[1]
    s = torch.where(valid, _f32(scores, valid), -math.inf)
    order = torch.argsort(-s, dim=-1, stable=True)             # best first
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=dev).expand_as(order))
    nv = torch.sum(valid, -1, keepdim=True)
    j = torch.arange(n_hypotheses, dtype=torch.float32, device=dev) / max(
        n_hypotheses - 1, 1)
    # quadratic ramp (the PROSAC growth function's shape): T_j from
    # 2*mn to nv
    t_j = (2.0 * mn + (nv.to(torch.float32) - 2.0 * mn)
           * j * j).to(torch.int64)                            # [..., S]
    t_j = torch.minimum(torch.clamp_min(t_j, mn), nv)
    ok = (rank[..., None, :] < t_j[..., :, None]) & valid[..., None, :]
    return top_k_largest(g + torch.where(ok, 0.0, -math.inf), mn)[1]


def combination_minimal_samples(n_hypotheses: int, mn: int, n: int):
    """Deterministic exhaustive combination enumeration (reference:
    optim/combination_sampler.cc): hypothesis j gets the j-th
    lexicographic mn-combination of [0, n), wrapping around once all
    C(n, mn) combinations are exhausted — the reference resets its
    iota state the same way (combination_sampler.cc:64-68). With
    n_hypotheses >= C(n, mn) this makes RANSAC exhaustive and
    deterministic on small problems. Shape-only: [S, mn] int64 on the CPU.

    With n < mn there are no valid combinations (C(n, mn) = 0): picks
    degenerate to repeated indices so the solver sees a rank-deficient
    sample and ransac reports success=False instead of crashing."""
    out = np.empty((n_hypotheses, mn), np.int64)
    if n < mn:
        out[:] = np.arange(mn, dtype=np.int64) % max(n, 1)
        return torch.from_numpy(out)
    it = itertools.combinations(range(n), mn)
    for j in range(n_hypotheses):
        c = next(it, None)
        if c is None:
            it = itertools.combinations(range(n), mn)
            c = next(it)
        out[j] = c
    return torch.from_numpy(out)


def n_combinations(n: int, mn: int) -> int:
    """MaxNumSamples of the combination sampler (NChooseK)."""
    return math.comb(n, mn)


class RansacResult(NamedTuple):
    model: torch.Tensor       # [..., 2, 3] affine or [..., 3, 3] homography
    inliers: torch.Tensor     # [..., N] bool
    n_inliers: torch.Tensor   # [...] int32
    success: torch.Tensor     # [...] bool


def _gather_pts(pts, picks):
    """pts [..., N, 2], picks [..., S, mn] -> [..., S, mn, 2]."""
    lead = picks.shape[:-2]
    s, mn = picks.shape[-2:]
    idx = picks.reshape(lead + (s * mn, 1)).expand(lead + (s * mn, 2))
    return torch.gather(pts.expand(lead + pts.shape[-2:]), -2,
                        idx).reshape(lead + (s, mn, 2))


def _models_finite(models, n_lead: int):
    return torch.all(torch.isfinite(models.flatten(n_lead + 1)), -1)


def _score(spec, models, src, dst, valid, t2):
    """Inlier masks [..., S, N] of models [..., S, ...] on all points."""
    proj = spec["apply"](models, src[..., None, :, :])
    res2 = torch.sum((proj - dst[..., None, :, :]) ** 2, -1)
    return (res2 < t2) & valid[..., None, :]


def _along_s(x, idx, n_lead: int):
    """x [*lead, S, ...] taken at idx [*lead, ...] along its S dim ->
    idx.shape + x's trailing dims."""
    lead = x.shape[:n_lead]
    rows = math.prod(lead)
    xf = x.reshape((rows,) + x.shape[n_lead:])
    i = idx.reshape(rows, -1)
    out = xf[torch.arange(rows, device=x.device)[:, None], i]
    return out.reshape(idx.shape + x.shape[n_lead + 1:])


def _lo_refit(refit, spec, mn, src, dst, valid, t2, model, inl, iters):
    """LORANSAC's inner refit (loransac.h:54), batched: refit on the
    inliers, keep the refit where it holds at least as many inliers and
    the set it came from had >= mn members (with none, the zero-weight
    fit is finite garbage and 0 >= 0 would accept it)."""
    n_lead = inl.ndim - 1
    for _ in range(iters):
        mdl2 = refit(src, dst, inl.to(torch.float32))
        r2 = torch.sum((spec["apply"](mdl2, src) - dst) ** 2, -1)
        new_inl = (r2 < t2) & valid
        n_new = torch.sum(new_inl, -1)
        n_old = torch.sum(inl, -1)
        better = ((n_new >= n_old) & (n_old >= mn)
                  & torch.all(torch.isfinite(mdl2.flatten(n_lead)), -1))
        model = torch.where(
            better.reshape(better.shape + (1,) * (model.ndim - n_lead)),
            mdl2, model)
        inl = torch.where(better[..., None], new_inl, inl)
    return model, inl


def _result(model, inl, min_inliers):
    n_inl = torch.sum(inl, -1)
    return RansacResult(model=model, inliers=inl,
                        n_inliers=n_inl.to(torch.int32),
                        success=n_inl >= min_inliers)


def _prepare(src, dst, valid):
    src = _f32(src)
    dst = _f32(dst, src)
    if valid is None:
        valid = torch.ones(src.shape[:-1], dtype=torch.bool,
                           device=src.device)
    else:
        valid = torch.as_tensor(valid, device=src.device).to(torch.bool)
    return src, dst, valid


def ransac(gen, src, dst, valid=None, *, model: str = "affine",
           threshold: float = 4.0, n_hypotheses: int = 256,
           lo_iters: int = 2, min_inliers: int = 6,
           scores=None, sampler: str = "auto") -> RansacResult:
    """src/dst [..., N, 2] matched points, valid [..., N] mask; threshold
    in pixels; gen a torch.Generator (unused by the combination sampler;
    None means seed 0).

    scores (optional [..., N], higher = more confident) switches sampling
    to the PROSAC-style progressive sampler (progressive_sampler.cc).
    sampler="combination" enumerates minimal sets deterministically in
    lexicographic order (combination_sampler.cc) — exhaustive when
    n_hypotheses >= n_combinations(N, min_n); like the reference it
    ignores scores and the valid mask when sampling (invalid rows still
    never count as inliers).
    Returns the best model by inlier count and its inlier mask.
    """
    spec = _MODELS[model]
    src, dst, valid = _prepare(src, dst, valid)
    n = src.shape[-2]
    mn = spec["min_n"]
    t2 = threshold * threshold
    lead = src.shape[:-2]

    # ---- sample S minimal sets (uniform, progressive, or exhaustive) ---
    if sampler == "combination":
        picks = combination_minimal_samples(n_hypotheses, mn, n).to(
            src.device).expand(lead + (n_hypotheses, mn))
    else:
        if gen is None:
            gen = torch.Generator().manual_seed(0)
        picks = progressive_minimal_samples(gen, n_hypotheses, mn, valid,
                                            scores)          # [..., S, mn]

    # ---- fit all hypotheses and score all residuals --------------------
    models = spec["fit"](_gather_pts(src, picks), _gather_pts(dst, picks))
    inl = _score(spec, models, src, dst, valid, t2)          # [..., S, N]
    support = torch.where(_models_finite(models, len(lead)),
                          torch.sum(inl, -1), -1)
    best = torch.argmax(support, -1)                         # first maximum
    best_model = _along_s(models, best, len(lead))
    best_inl = _along_s(inl, best, len(lead))

    # ---- local optimization: weighted refit on inliers -----------------
    best_model, best_inl = _lo_refit(spec["fit"], spec, mn, src, dst, valid,
                                     t2, best_model, best_inl, lo_iters)
    return _result(best_model, best_inl, min_inliers)


def ransac_preemptive(gen, src, dst, valid=None, *, model: str = "affine",
                      threshold: float = 4.0, n_hypotheses: int = 1024,
                      n_survivors: int = 64, n_probe: int = 32,
                      lo_iters: int = 2,
                      min_inliers: int = 6) -> RansacResult:
    """Two-stage preemptive RANSAC — the batched analogue of SPRT
    (optim/sprt.h:45): ALL hypotheses are scored on a random n_probe-point
    subsample (cheap [S, n_probe] pass), the n_survivors best advance to
    full [S', N] scoring. The LO refit is the affine fit for
    model="affine" and the DLT homography otherwise, as in `cvt_tpu`.
    """
    spec = _MODELS[model]
    src, dst, valid = _prepare(src, dst, valid)
    n = src.shape[-2]
    mn = spec["min_n"]
    t2 = threshold * threshold
    lead = src.shape[:-2]
    if gen is None:
        gen = torch.Generator().manual_seed(0)

    logits = torch.where(valid, 0.0, -math.inf)
    g = _gumbel(gen, lead + (n_hypotheses, n), src.device)
    picks = top_k_largest(g + logits[..., None, :], mn)[1]
    models = spec["fit"](_gather_pts(src, picks), _gather_pts(dst, picks))
    finite = _models_finite(models, len(lead))               # [..., S]

    # stage 1: probe on a shared random subset of valid observations
    gp = _gumbel(gen, lead + (n,), src.device) + logits
    probe = top_k_largest(gp, min(n_probe, n))[1]            # [..., P]
    p_src, p_dst, p_valid = (_along_s(a, probe, len(lead))
                             for a in (src, dst, valid))
    sup_p = torch.sum(_score(spec, models, p_src, p_dst, p_valid, t2), -1)
    sup_p = torch.where(finite, sup_p, -1)
    keep = top_k_largest(sup_p, min(n_survivors, n_hypotheses))[1]

    # stage 2: full scoring of the survivors only
    mk = _along_s(models, keep, len(lead))
    inl = _score(spec, mk, src, dst, valid, t2)
    support = torch.where(_along_s(finite, keep, len(lead)),
                          torch.sum(inl, -1), -1)
    best = torch.argmax(support, -1)
    best_model = _along_s(mk, best, len(lead))
    best_inl = _along_s(inl, best, len(lead))

    refit = fit_affine if model == "affine" else fit_homography_dlt
    best_model, best_inl = _lo_refit(refit, spec, mn, src, dst, valid, t2,
                                     best_model, best_inl, lo_iters)
    return _result(best_model, best_inl, min_inliers)
