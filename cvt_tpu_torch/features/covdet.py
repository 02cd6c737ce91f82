"""Top-level SIFT extraction: images in, fixed-size features out
(counterpart of `cvt_tpu.features.covdet`).

The public equivalent of `vl_covdet()` (covdet/vl_covdet.hpp:33-266) and
`ExtractSiftFeaturesCPU` (retrieval/vlindex/src/feature/sift.cc:422):
grayscale images -> keypoint frames (x, y, sigma, angle) + 128-d
descriptors. Ragged per-image keypoint counts become fixed [B, maxK]
slots with a validity mask.

Per octave: detect -> refine -> orient -> describe; octave results are
concatenated and reduced to the global top-maxK by |response| — matching
the reference's max_num_features cap (sift.h:62, makeSIFTs.cpp cap 128).
Every selection takes `jax.lax.top_k`'s tie order (`ops/topk`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cvt_tpu_torch.features.affine import estimate_affine_shape
from cvt_tpu_torch.features.descriptor import (
    _interleave, assign_orientations, assign_orientations_multi,
    assign_orientations_multi_flat, root_sift, sift_descriptors,
    sift_descriptors_flat)
from cvt_tpu_torch.features.detect import detect_octave, hessian_response
from cvt_tpu_torch.features.scale_space import build_pyramid
from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.utils.device import resolve_device


@dataclass
class SiftFeatures:
    """frames [B, K, 4] = (x, y, sigma, angle) in input-image coords;
    descriptors [B, K, 128]; response [B, K]; valid [B, K] bool."""
    frames: torch.Tensor
    descriptors: torch.Tensor
    response: torch.Tensor
    valid: torch.Tensor
    affine: torch.Tensor | None = None   # [B, K, 2, 2] unit-det shape

    @property
    def n_valid(self):
        return torch.sum(self.valid, -1)


def _take(a: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """take_along_axis on dim 1 for [B, N, ...] by sel [B, K]."""
    idx = sel.reshape(sel.shape + (1,) * (a.ndim - 2)).expand(
        sel.shape + a.shape[2:])
    return torch.gather(a, 1, idx)


def _response_stack(octv, detector: str, n_scales: int):
    if detector == "hessian":
        return hessian_response(octv.gauss, n_scales=n_scales)
    if detector == "dog":
        return octv.dog
    raise ValueError(f"unknown detector {detector!r}")


def _dsp_ratios(dsp_num_scales, dsp_min_scale, dsp_max_scale):
    return np.geomspace(dsp_min_scale, dsp_max_scale,
                        dsp_num_scales).astype(np.float32)


def _dsp_normalize(acc, dsp_num_scales, valid):
    d = acc / float(dsp_num_scales)
    d = d * torch.rsqrt(torch.sum(torch.square(d), -1, keepdim=True) + 1e-12)
    return torch.where(valid[..., None], d, 0.0)


def extract_sift(images, *, max_features: int = 512,
                 peak_threshold: float | None = None,
                 edge_threshold: float = 10.0,
                 first_octave: int = -1, n_scales: int = 3,
                 rootsift: bool = False,
                 n_orientations: int = 1,
                 detector: str = "dog",
                 affine_shape: bool = False,
                 dsp_num_scales: int = 1,
                 dsp_min_scale: float = 1.0 / 6.0,
                 dsp_max_scale: float = 3.0,
                 max_per_octave: int | None = None,
                 device=None) -> SiftFeatures:
    """images [B, H, W] float in [0, 1] (grayscale) -> SiftFeatures.

    Defaults mirror vlindex (sift.h:59-84); rootsift=True applies the
    L1-sqrt transform of hnsw_sifts_retrieval.

    n_orientations > 1 duplicates keypoints at secondary orientation
    peaks >= 0.8x max, the reference's vl_covdet_extract_orientations
    behavior (vl_covdet.hpp:174-186) — each duplicate gets its own
    descriptor slot.

    dsp_num_scales > 1 enables DSP-SIFT domain-size pooling
    (sift.h:97-100): descriptors are averaged over dsp_num_scales
    domain sizes geometrically spaced in [dsp_min_scale, dsp_max_scale]
    x sigma, then re-normalized.

    detector: "dog" (difference of Gaussians) or "hessian" — the
    scale-normalized determinant-of-Hessian response, the reference
    covdet DEFAULT (vl_covdet.hpp:73-88 METHOD_HESSIAN; its
    peakThreshold default there is 5e-4, applied here when
    peak_threshold is left unset).

    affine_shape=True runs the second-moment affine adaptation
    (vl_covdet_extract_affine_shape, :159-173) and samples orientations
    + descriptors through each keypoint's elliptical shape; the
    estimated unit-det A matrices land in SiftFeatures.affine.

    A tensor keeps its device; numpy goes to `device` (default the card).
    """
    if peak_threshold is None:
        peak_threshold = 5e-4 if detector == "hessian" else 0.02 / 3
    dev = resolve_device(device, like=images)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    if images.ndim == 2:
        images = images[None]
    pyr = build_pyramid(images, n_scales=n_scales,
                        first_octave=first_octave, with_gradients=True)
    b = images.shape[0]
    per_oct = max_per_octave or max_features

    if not affine_shape:
        # detect on every octave, select the GLOBAL top-max_features by
        # |response| first, then sample orientations and descriptors once
        # over a concatenated flat gradient stack: the same result as
        # describing everything and selecting after (selection is by
        # response, which per-keypoint processing never changes)
        return _extract_fast(pyr, b, per_oct, max_features, peak_threshold,
                             edge_threshold, n_scales, rootsift,
                             n_orientations, detector, dsp_num_scales,
                             dsp_min_scale, dsp_max_scale)

    def describe(octv, x_f, y_f, sigma_oct, lev_i, ang, valid, am):
        if dsp_num_scales <= 1:
            return sift_descriptors(octv.grad_dx, octv.grad_dy, x_f, y_f,
                                    sigma_oct, lev_i, ang, valid,
                                    affine=am)
        # DSP: average the descriptor over pooled domain sizes
        acc = 0.0
        for rt in _dsp_ratios(dsp_num_scales, dsp_min_scale, dsp_max_scale):
            acc = acc + sift_descriptors(
                octv.grad_dx, octv.grad_dy, x_f, y_f,
                sigma_oct * float(rt), lev_i, ang, valid, affine=am)
        return _dsp_normalize(acc, dsp_num_scales, valid)

    parts = []
    for octv in pyr:
        resp_stack = _response_stack(octv, detector, n_scales)
        x_f, y_f, l_f, lev_i, resp, valid = detect_octave(
            resp_stack, max_k=per_oct, peak_threshold=peak_threshold,
            edge_threshold=edge_threshold)
        # sigma in octave pixels from the refined level coordinate
        sigma_oct = 1.6 * (2.0 ** (l_f / float(n_scales)))
        am = estimate_affine_shape(octv.grad_dx, octv.grad_dy, x_f, y_f,
                                   sigma_oct, lev_i, valid)
        if n_orientations > 1:
            # duplicate keypoints per orientation peak: [B, K, O] -> K*O
            angs, aok = assign_orientations_multi(
                octv.grad_dx, octv.grad_dy, x_f, y_f, sigma_oct, lev_i,
                valid, n_orientations=n_orientations, affine=am)
            o = n_orientations
            x_f, y_f, sigma_oct, lev_i, resp, am = (
                a.repeat_interleave(o, 1)
                for a in (x_f, y_f, sigma_oct, lev_i, resp, am))
            ang = angs.reshape(b, -1)
            valid = aok.reshape(b, -1)
        else:
            ang = assign_orientations(octv.grad_dx, octv.grad_dy, x_f,
                                      y_f, sigma_oct, lev_i, valid,
                                      affine=am)
        # gradients live on the Gaussian levels; use the nearest level
        desc = describe(octv, x_f, y_f, sigma_oct, lev_i, ang, valid, am)
        step = octv.step
        parts.append(dict(
            x=x_f * step, y=y_f * step, sigma=sigma_oct * step,
            angle=ang, resp=torch.where(valid, resp, 0.0),
            valid=valid, desc=desc, aff=am))

    cat = {k: torch.cat([p[k] for p in parts], 1) for k in parts[0]}
    # global top-maxK by |response|
    score = torch.where(cat["valid"], torch.abs(cat["resp"]), -1.0)
    _, sel = top_k_largest(score, min(max_features, score.shape[1]))
    take = {k: _take(v, sel) for k, v in cat.items()}
    frames = torch.stack([take["x"], take["y"], take["sigma"],
                          take["angle"]], -1)
    desc = take["desc"]
    valid = take["valid"] & (take["resp"] != 0.0)
    if rootsift:
        desc = torch.where(valid[..., None], root_sift(desc), 0.0)
    return SiftFeatures(frames=frames, descriptors=desc,
                        response=take["resp"], valid=valid,
                        affine=take["aff"])


def _extract_fast(pyr, b, per_oct, max_features, peak_threshold,
                  edge_threshold, n_scales, rootsift, n_orientations,
                  detector, dsp_num_scales, dsp_min_scale, dsp_max_scale):
    """Global-top-K-first extraction (see extract_sift)."""
    # ---- pass 1: detection on every octave -----------------------------
    det = dict(x=[], y=[], lf=[], lev=[], resp=[], valid=[], oct=[])
    meta_base, meta_h, meta_w, meta_step = [], [], [], []
    offset = 0
    for oi, octv in enumerate(pyr):
        resp_stack = _response_stack(octv, detector, n_scales)
        l, h, w = octv.grad_dx.shape[1:]
        # an octave cannot yield more keypoints than candidate positions
        k_oct = min(per_oct, resp_stack[0].numel())
        x_f, y_f, l_f, lev_i, resp, valid = detect_octave(
            resp_stack, max_k=k_oct, peak_threshold=peak_threshold,
            edge_threshold=edge_threshold)
        for key, v in (("x", x_f), ("y", y_f), ("lf", l_f), ("lev", lev_i),
                       ("resp", resp), ("valid", valid),
                       ("oct", torch.full_like(lev_i, oi))):
            det[key].append(v)
        meta_base.append(offset)
        meta_h.append(h)
        meta_w.append(w)
        meta_step.append(octv.step)
        offset += l * h * w
    cat = {k: torch.cat(v, 1) for k, v in det.items()}

    # ---- global selection BEFORE sampling ------------------------------
    k_det = min(max_features, cat["resp"].shape[1])
    score = torch.where(cat["valid"], torch.abs(cat["resp"]), -1.0)
    _, sel = top_k_largest(score, k_det)
    x_f, y_f, l_f, lev_i, resp, valid, oct_i = (
        _take(cat[k], sel) for k in ("x", "y", "lf", "lev", "resp", "valid",
                                     "oct"))
    sigma_oct = 1.6 * (2.0 ** (l_f / float(n_scales)))

    # ---- flat gradient stack (interleaved dx, dy) + octave metadata ----
    gf = torch.cat([_interleave(o.grad_dx, o.grad_dy) for o in pyr], 1)
    meta_base, meta_h, meta_w = (
        torch.tensor(m, dtype=torch.int64, device=gf.device)
        for m in (meta_base, meta_h, meta_w))
    step_arr = torch.tensor(meta_step, dtype=torch.float32,
                            device=gf.device)

    # ---- orientation (with duplication) --------------------------------
    angs, aok = assign_orientations_multi_flat(
        gf, meta_base, meta_h, meta_w, oct_i, x_f, y_f, sigma_oct, lev_i,
        valid, n_orientations=max(n_orientations, 1))
    if n_orientations > 1:
        o = n_orientations
        x_f, y_f, sigma_oct, lev_i, resp, oct_i = (
            a.repeat_interleave(o, 1)
            for a in (x_f, y_f, sigma_oct, lev_i, resp, oct_i))
        ang = angs.reshape(b, -1)
        valid = aok.reshape(b, -1)
    else:
        # dominant peak only; keep the original validity semantics
        ang = angs[..., 0]

    # ---- descriptors (+ optional DSP pooling) --------------------------
    def describe(sig):
        return sift_descriptors_flat(gf, meta_base, meta_h, meta_w, oct_i,
                                     x_f, y_f, sig, lev_i, ang, valid)

    if dsp_num_scales <= 1:
        desc = describe(sigma_oct)
    else:
        acc = 0.0
        for rt in _dsp_ratios(dsp_num_scales, dsp_min_scale, dsp_max_scale):
            acc = acc + describe(sigma_oct * float(rt))
        desc = _dsp_normalize(acc, dsp_num_scales, valid)

    # ---- final cap over duplicated slots -------------------------------
    step = step_arr[oct_i]
    if x_f.shape[1] > max_features:
        score2 = torch.where(valid, torch.abs(resp), -1.0)
        _, sel2 = top_k_largest(score2, max_features)
        x_f, y_f, sigma_oct, ang, resp, valid, step, desc = (
            _take(a, sel2) for a in (x_f, y_f, sigma_oct, ang, resp, valid,
                                     step, desc))
    frames = torch.stack([x_f * step, y_f * step, sigma_oct * step, ang], -1)
    valid = valid & (resp != 0.0)
    if rootsift:
        desc = torch.where(valid[..., None], root_sift(desc), 0.0)
    return SiftFeatures(frames=frames, descriptors=desc,
                        response=torch.where(valid, resp, 0.0),
                        valid=valid, affine=None)
