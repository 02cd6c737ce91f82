"""Template matching in frames/images: GHT-style verification
(counterpart of `cvt_tpu.apps.template_match`).

Reference:
  * video_object_match/src/GHT.cpp — per-frame SIFT + FLANN 2-NN ratio
    match (demo.cpp distRatio=0.9, numThrehold=10), SVF spatial
    validation (:6-156), OCTAVE-difference histogram validation
    (`OctaveDiff`/`OctaveValidate`, :157-180: matches must agree on a
    dominant scale ratio), optional cv::findHomography RANSAC (:238-255).
  * detection_and_tracking/logo_detection — SIFT templates packed into a
    model (make_model.cc), per-image 1-NN threshold match
    (logo.cc:104-105, sift_near_thresh), SVF validation (logo.cc:237).

Frames are processed as a batch: one `extract_sift` call for all
frames, then one [T, Kt, Kf] distance product and one top-2 along its
last dim, SVF, the octave check and RANSAC each with T as a leading
batch dim. No Python loop runs over frames. RANSAC draws from one
`torch.Generator` (seed 0 when none is given) where `cvt_tpu` splits
`jax.random.key(0)` per frame: the samples cannot equal JAX's bits. The
logo pack (`LogoDetector.save` / `load`) keeps `cvt_tpu`'s `.npz` keys,
so a pack saved by either package loads in the other.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from cvt_tpu_torch.features.covdet import SiftFeatures, extract_sift
from cvt_tpu_torch.match.nn import match_descriptors
from cvt_tpu_torch.match.ransac import ransac
from cvt_tpu_torch.match.svf import svf_inliers
from cvt_tpu_torch.utils.device import resolve_device


def octave_validate(sigma1, sigma2, valid, *, n_bins: int = 11,
                    min_frac: float = 0.5):
    """Scale-ratio (octave-difference) histogram validation
    (GHT.cpp:157-180): inlier matches must agree on a dominant
    log2(sigma2/sigma1) bin. Returns mask of matches in the dominant bin
    (all False when no bin reaches `min_frac` of the votes). Inputs
    [..., N] (broadcast), one histogram per leading index."""
    valid = torch.as_tensor(valid)
    sigma1 = torch.as_tensor(sigma1, dtype=torch.float32, device=valid.device)
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=valid.device)
    ds = torch.log2((sigma2 + 1e-6) / (sigma1 + 1e-6))
    bins = torch.clamp(torch.round(ds).to(torch.int64) + n_bins // 2,
                       0, n_bins - 1)
    bins, valid = torch.broadcast_tensors(bins, valid)
    hist = torch.zeros(bins.shape[:-1] + (n_bins,), dtype=torch.float32,
                       device=bins.device).scatter_add_(
        -1, bins, valid.to(torch.float32))
    total = torch.clamp_min(torch.sum(hist, -1, keepdim=True), 1.0)
    top, best = torch.max(hist, -1, keepdim=True)          # first maximum
    ok = top / total >= min_frac
    return valid & (bins == best) & ok


def hog_descriptor(img, *, cell: int = 8, n_bins: int = 9):
    """Batched HOG: [..., H, W] gray -> [..., nH*nW*n_bins] f32,
    L2-normalized. The logo detector's SECONDARY decision signal
    (logo_detection/src/logo.cc:360-394 computes a HOG distance between
    the template and its matched subwindow). Unsigned orientation
    (mod pi), hard cell binning — batched, no per-pixel loops."""
    img = torch.as_tensor(img, dtype=torch.float32)
    h, w = img.shape[-2], img.shape[-1]
    hc, wc = (h // cell) * cell, (w // cell) * cell
    g = img[..., :hc, :wc]
    gx = 0.5 * (torch.roll(g, -1, -1) - torch.roll(g, 1, -1))
    gy = 0.5 * (torch.roll(g, -1, -2) - torch.roll(g, 1, -2))
    mag = torch.sqrt(gx * gx + gy * gy)
    ang = torch.remainder(torch.atan2(gy, gx), torch.pi)   # unsigned [0, pi)
    b = torch.clamp((ang / torch.pi * n_bins).to(torch.int64), 0,
                    n_bins - 1)
    onehot = F.one_hot(b, n_bins).to(torch.float32) * mag[..., None]
    cells = onehot.reshape(img.shape[:-2]
                           + (hc // cell, cell, wc // cell, cell, n_bins))
    d = torch.sum(cells, dim=(-2, -4)).reshape(img.shape[:-2] + (-1,))
    return d * torch.rsqrt(torch.sum(d * d, -1, keepdim=True) + 1e-12)


def _warp_affine_patch(frame, model, out_h: int, out_w: int):
    """Sample `frame` [..., H, W] at model([..., 2, 3] template->frame)
    applied to the template pixel grid -> [..., out_h, out_w] warped
    patch (`features.descriptor.bilinear_sample`'s clamped taps)."""
    h, w = frame.shape[-2:]
    ys, xs = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=frame.device),
        torch.arange(out_w, dtype=torch.float32, device=frame.device),
        indexing="ij")
    m = model[..., None, None, :, :]
    fx = m[..., 0, 0] * xs + m[..., 0, 1] * ys + m[..., 0, 2]
    fy = m[..., 1, 0] * xs + m[..., 1, 1] * ys + m[..., 1, 2]
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, h - 2)
    tx = torch.clamp(fx - x0, 0.0, 1.0)
    ty = torch.clamp(fy - y0, 0.0, 1.0)
    flat = frame.reshape(frame.shape[:-2] + (h * w,))

    def tap(y, x):
        i = (y * w + x).reshape(frame.shape[:-2] + (-1,))
        return torch.gather(flat, -1, i).reshape(fx.shape)
    return ((1 - ty) * ((1 - tx) * tap(y0, x0) + tx * tap(y0, x0 + 1))
            + ty * ((1 - tx) * tap(y0 + 1, x0) + tx * tap(y0 + 1, x0 + 1)))


@dataclass
class TemplateMatch:
    """Per-frame result: hit flag, #verified inliers, affine model."""
    hits: np.ndarray        # [T] bool
    n_inliers: np.ndarray   # [T] int32
    models: np.ndarray      # [T, 2, 3] affine template->frame
    hog_dist: np.ndarray | None = None   # [T] f32 (match_frames only)


class TemplateMatcher:
    """Find a template object inside a batch of frames/images."""

    def __init__(self, template_image=None, *, features=None,
                 template_shape=None, template_hog=None,
                 max_features: int = 256,
                 ratio: float = 0.9, min_matches: int = 10,
                 hog_threshold: float | None = None,
                 use_octave_check: bool = True,
                 use_ransac: bool = True, ransac_threshold: float = 10.0,
                 device=None):
        """template_image [H, W] gray in [0, 1]; or precomputed
        `features` (SiftFeatures) + `template_shape` (+ optional
        `template_hog`) from a saved model pack (make_model.cc analogue).
        Runs on `device` (default: the card; tensors keep theirs).

        hog_threshold enables the reference's secondary HOG decision
        (logo.cc:387-394): a frame also matches when the HOG distance
        between the template and its affine-matched subwindow is <= the
        threshold — and with BOTH thresholds active the reference
        accepts on EITHER signal."""
        if template_image is not None:
            dev = resolve_device(device, like=template_image)
            t = torch.as_tensor(template_image, dtype=torch.float32,
                                device=dev)[None]
            self.tmpl = extract_sift(t, max_features=max_features,
                                     rootsift=True)
            self.template_shape = tuple(t.shape[1:])
            self.template_hog = hog_descriptor(t[0])
        else:
            if features is None or template_shape is None:
                raise ValueError("need template_image or features"
                                 " + template_shape")
            dev = resolve_device(device, like=features.frames)
            self.tmpl = SiftFeatures(
                *(torch.as_tensor(a, device=dev) for a in (
                    features.frames, features.descriptors,
                    features.response, features.valid)))
            self.template_shape = tuple(int(s) for s in template_shape)
            self.template_hog = (None if template_hog is None else
                                 torch.as_tensor(template_hog,
                                                 dtype=torch.float32,
                                                 device=dev))
        self.device = dev
        self.ratio = ratio
        self.min_matches = min_matches
        self.hog_threshold = hog_threshold
        self.use_octave_check = use_octave_check
        self.use_ransac = use_ransac
        self.ransac_threshold = ransac_threshold
        self.max_features = max_features

    def match_features(self, feats: SiftFeatures, gen=None) -> TemplateMatch:
        """Verify the template against pre-extracted frame features
        [T, Kf, ...], all frames at once. gen: the RANSAC's
        torch.Generator (None: seed 0)."""
        td = self.tmpl.descriptors[0]
        tf = self.tmpl.frames[0]
        tv = self.tmpl.valid[0]
        n_frames = feats.descriptors.shape[0]
        m = match_descriptors(td, feats.descriptors, valid1=tv,
                              valid2=feats.valid, ratio=self.ratio)
        p1 = tf[:, :2].expand(n_frames, -1, -1)               # [T, Kt, 2]
        f2 = torch.gather(feats.frames, 1,
                          m.idx2[..., None].expand(-1, -1, 4))
        inl = svf_inliers(p1, tf[:, 3].expand(n_frames, -1), f2[..., :2],
                          f2[..., 3], m.valid)
        if self.use_octave_check:
            inl = octave_validate(tf[:, 2], f2[..., 2], inl)
        if self.use_ransac:
            res = ransac(gen, p1, f2[..., :2], inl, model="affine",
                         threshold=self.ransac_threshold, n_hypotheses=128,
                         min_inliers=self.min_matches)
            n_inl, models = res.n_inliers, res.model
        else:
            n_inl = torch.sum(inl, -1).to(torch.int32)
            models = torch.zeros((n_frames, 2, 3), device=inl.device)
        n_inl = n_inl.cpu().numpy()
        return TemplateMatch(hits=n_inl >= self.min_matches,
                             n_inliers=n_inl, models=models.cpu().numpy())

    def match_frames(self, frames, gen=None) -> TemplateMatch:
        """frames [T, H, W] gray in [0, 1] -> per-frame verification.

        With hog_threshold set, also computes the HOG distance between
        the template and each frame's affine-matched subwindow and
        accepts frames on EITHER the SIFT-inlier or the HOG signal
        (logo.cc:387-394 decision table; -1/None disables a signal)."""
        frames = torch.as_tensor(frames, dtype=torch.float32,
                                 device=self.device)
        feats = extract_sift(frames, max_features=self.max_features,
                             rootsift=True)
        res = self.match_features(feats, gen=gen)
        if self.hog_threshold is None or self.template_hog is None:
            return res
        th, tw = self.template_shape
        patches = _warp_affine_patch(
            frames, torch.as_tensor(res.models, device=self.device), th, tw)
        hog_d = torch.linalg.vector_norm(
            hog_descriptor(patches) - self.template_hog, dim=-1)
        hog_d = hog_d.cpu().numpy()
        return TemplateMatch(hits=res.hits | (hog_d <= self.hog_threshold),
                             n_inliers=res.n_inliers, models=res.models,
                             hog_dist=hog_d)


class LogoDetector:
    """Multi-template detector (logo_detection equivalent): each logo is
    a set of template images; an image is flagged when any template
    verifies with enough inliers (logo.cc decision rules :387-394,
    without the HOG secondary check)."""

    def __init__(self, templates: dict | None = None, *, device=None,
                 **matcher_kwargs):
        """templates: {logo_name: [template_image, ...]}; or build from
        a saved pack with LogoDetector.load(). Runs on `device` (default
        the card)."""
        self.device = resolve_device(device)
        self.matchers = {} if templates is None else {
            name: [TemplateMatcher(img, device=self.device, **matcher_kwargs)
                   for img in imgs]
            for name, imgs in templates.items()}

    # -- template model pack (the make_model.cc .dat analogue) ----------
    def save(self, path: str) -> None:
        """Pack every template's precomputed features + HOG + thresholds
        into one npz in `cvt_tpu`'s keys (make_model.cc:149-277 packs
        per-template name, SIFT features, thresholds, and the template
        image; here the image is replaced by its extracted features +
        HOG, which is all detection needs)."""
        def host(t):
            return t.detach().cpu().numpy()
        arrays: dict = {}
        names = []
        for name, ms in self.matchers.items():
            for m in ms:
                i = len(names)
                names.append(name)
                t = m.tmpl
                arrays[f"t{i}_frames"] = host(t.frames[0])
                arrays[f"t{i}_desc"] = host(t.descriptors[0])
                arrays[f"t{i}_resp"] = host(t.response[0])
                arrays[f"t{i}_valid"] = host(t.valid[0])
                arrays[f"t{i}_hog"] = (host(m.template_hog)
                                       if m.template_hog is not None
                                       else np.zeros(0, np.float32))
                arrays[f"t{i}_shape"] = np.asarray(m.template_shape,
                                                   np.int32)
                arrays[f"t{i}_thr"] = np.asarray(
                    [m.min_matches,
                     -1.0 if m.hog_threshold is None else m.hog_threshold,
                     m.ratio, m.ransac_threshold], np.float32)
        arrays["names"] = np.asarray(names)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, *, device=None,
             **matcher_kwargs) -> "LogoDetector":
        """Rebuild a detector from a pack written by save() (either
        package's) — no template images or re-extraction needed (the
        factory API of logo.h:16-24 Logo/LogoFactory)."""
        z = np.load(path, allow_pickle=False)
        det = cls(None, device=device)
        names = [str(s) for s in z["names"]]
        for i, name in enumerate(names):
            feats = SiftFeatures(*(
                torch.from_numpy(np.array(z[f"t{i}_{k}"]))[None]
                for k in ("frames", "desc", "resp", "valid")))
            thr = z[f"t{i}_thr"]
            hog = z[f"t{i}_hog"]
            kw = dict(min_matches=int(thr[0]),
                      hog_threshold=None if thr[1] < 0 else float(thr[1]),
                      ratio=float(thr[2]), ransac_threshold=float(thr[3]))
            kw.update(matcher_kwargs)
            m = TemplateMatcher(
                features=feats, template_shape=tuple(z[f"t{i}_shape"]),
                template_hog=(hog if hog.size else None),
                device=det.device, **kw)
            det.matchers.setdefault(name, []).append(m)
        return det

    def detect(self, images, gen=None):
        """images [B, H, W] -> list of {logo_name: n_inliers} per image.
        gen: one torch.Generator for every template's RANSAC; None seeds
        each template's RANSAC with 0 (`cvt_tpu` passes every template
        the same key)."""
        x = torch.as_tensor(images, dtype=torch.float32, device=self.device)
        feats = extract_sift(x, rootsift=True)
        out = [dict() for _ in range(x.shape[0])]
        for name, matchers in self.matchers.items():
            for m in matchers:
                res = m.match_features(feats, gen=gen)
                for i in np.flatnonzero(res.hits):
                    out[i][name] = max(out[i].get(name, 0),
                                       int(res.n_inliers[i]))
        return out
