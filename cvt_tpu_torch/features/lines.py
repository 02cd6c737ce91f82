"""LSD-style line segment detector, batched (counterpart of
`cvt_tpu.features.lines`).

Reference: the vendored LSD library (retrieval/vlindex/lib/LSD/ — the
von Gioi et al. "LSD: a Line Segment Detector" TPAMI'10 / IPOL'12
algorithm): Gaussian downscale -> level-line field (gradient angle) ->
region growing of aligned pixels -> rectangle approximation -> NFA
(number of false alarms) validation.

As in `cvt_tpu`, the reference's sequential region growing is replaced
by a batched connected-component pass over the whole aligned-pixel
field:

  * level-line angles + magnitudes from 2x2 difference stencils;
  * aligned-pixel components via iterative min-label propagation with
    pointer jumping (each step: 8-neighbour min over label maps gated by
    pairwise angle alignment, then one label=label[label] gather hop).
    The eight alignment masks do not change between steps and are built
    once. The host reads the convergence flag once every `_CHECK_EVERY`
    steps; a step at the fixed point changes nothing, so the labels are
    exactly those of a per-step check (`last_propagation_steps` holds the
    step count of the last call, the steps up to the first that changed
    nothing, as `cvt_tpu`'s while_loop counts them);
  * per-component rectangle moments by `index_add_` over the label map:
    weighted center, principal axis from the 2x2 second-moment
    eigenvector, length/width from the moments (region2rect);
  * NFA validation in the log domain (lgamma binomial tail) with the
    same (N*M)^{5/2} trial count and `cvt_tpu`'s p = tau/pi
    (`cvt_tpu/features/lines.py:211`; the reference's 2·tau/pi is not
    applied here either).

Two numerical changes against `cvt_tpu`, which sums x, y, x^2, ... in
float32 about the image origin and forms m = s/w - c^2 in float32: that
cancels at cx^2 + cy^2 (~4e5 at 640 x 480) and moves short segments far
from the origin by tenths of a pixel, and a one-ulp change of a
gradient magnitude (the card's against the CPU's) moves them as much.
Here each component's moments are taken about its own label pixel, so
m cancels at the component's extent, and summed in float64 (rounded
once to float32), so they do not depend on the order of the card's
atomics. The port's rectangles agree with `cvt_tpu`'s to `cvt_tpu`'s own
rounding (tests/_lines_tolerance.py) and with each other across devices
far closer. `arctan2` may differ by an ulp between the
packages, so a pixel pair whose angle difference lies within an ulp of
tau may join in one and not in the other.

Deviations from the reference (as `cvt_tpu`): pixels join a component
when mutually aligned within tau of EACH OTHER, and there is no
per-rectangle refinement loop (NFA simply rejects weak rectangles).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.utils.device import resolve_device

_NO_LABEL = 2 ** 30
_CHECK_EVERY = 8
_NEIGHBOURS = ((0, 1), (0, -1), (1, 0), (-1, 0),
               (1, 1), (1, -1), (-1, 1), (-1, -1))

last_propagation_steps = 0


class LineSegments(NamedTuple):
    """segments [B, L, 4] = (x1, y1, x2, y2) in pixels; width [B, L];
    angle [B, L] radians; nfa [B, L] -log10(NFA) (bigger = more
    significant); valid [B, L] bool."""
    segments: torch.Tensor
    width: torch.Tensor
    angle: torch.Tensor
    nfa: torch.Tensor
    valid: torch.Tensor


def _level_lines(img):
    """2x2 stencil gradients (LSD's ll_angle): returns (angle of the
    level line, gradient magnitude)."""
    a = img
    b = torch.roll(img, -1, dims=-1)                     # x+1
    c = torch.roll(img, -1, dims=-2)                     # y+1
    d = torch.roll(torch.roll(img, -1, dims=-2), -1, dims=-1)
    gx = 0.5 * ((b - a) + (d - c))
    gy = 0.5 * ((c - a) + (d - b))
    mag = torch.sqrt(gx * gx + gy * gy)
    # the roll-based stencil wraps at the last row/column (opposite-edge
    # differences would fabricate high-NFA border segments); mark them
    # unusable like the reference's NOTDEF border (lsd.c ll_angle)
    mag[..., -1] = 0.0
    mag[..., -1, :] = 0.0
    # level-line angle is perpendicular to the gradient
    return torch.atan2(gx, -gy), mag


def _angle_diff(a, b):
    """Smallest difference of undirected line angles (mod pi). The
    argument is never negative, so fmod is `cvt_tpu`'s `%`, exactly."""
    d = torch.fmod(torch.abs(a - b), math.pi)
    return torch.minimum(d, math.pi - d)


def _shift(x, dy, dx, fill):
    """x [..., H, W] rolled by (dy, dx) with the wrapped rows / columns
    set to `fill`."""
    out = x
    if dy:
        out = torch.roll(out, dy, dims=-2)
        out[..., slice(0, dy) if dy > 0 else slice(dy, None), :] = fill
    if dx:
        out = torch.roll(out, dx, dims=-1)
        out[..., slice(0, dx) if dx > 0 else slice(dx, None)] = fill
    return out


def _components(ang, usable, tau: float):
    """Min-label connected components of mutually aligned pixels ->
    (labels [B, H, W] int32, _NO_LABEL off the field; steps)."""
    b, h, w = ang.shape
    dev = ang.device
    flat_idx = torch.arange(h * w, dtype=torch.int32,
                            device=dev).reshape(1, h, w)
    labels = torch.where(usable, flat_idx, _NO_LABEL)
    joins = [usable & _shift(usable, dy, dx, False)
             & (_angle_diff(ang, _shift(ang, dy, dx, 0.0)) < tau)
             for dy, dx in _NEIGHBOURS]

    def step(labels):
        new = labels
        for (dy, dx), join in zip(_NEIGHBOURS, joins):
            new = torch.where(join, torch.minimum(
                new, _shift(labels, dy, dx, _NO_LABEL)), new)
        # pointer jumping: hop to the label's label (path halving)
        hop = torch.gather(new.reshape(b, -1), 1, torch.clamp(
            new.reshape(b, -1), 0, h * w - 1).long()).reshape(b, h, w)
        return torch.where(new < _NO_LABEL, torch.minimum(new, hop), new)

    steps = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    while True:
        for _ in range(_CHECK_EVERY):
            hop = step(labels)
            steps = steps + (~done).to(torch.int64)
            done = done | torch.all(hop == labels)
            labels = hop
        if bool(done):
            return labels, int(steps)


def _seg_sum(lab_flat, vals, n: int):
    """Per-image scatter-add of float32 vals [B, N] into [B, n] bins
    lab_flat, summed in float64 and rounded once to float32: the result
    does not depend on the order of the additions (the card's atomics)."""
    b = lab_flat.shape[0]
    idx = (lab_flat.long() + n * torch.arange(
        b, device=lab_flat.device)[:, None]).reshape(-1)
    out = torch.zeros(b * n, dtype=torch.float64, device=vals.device)
    out.index_add_(0, idx, vals.reshape(-1).to(torch.float64))
    return out.reshape(b, n).to(torch.float32)


def detect_line_segments(images, *, max_segments: int = 128,
                         grad_threshold: float = 0.02,
                         tau_deg: float = 22.5,
                         min_pixels: int = 16,
                         nfa_eps: float = 0.0,
                         device=None) -> LineSegments:
    """images [B, H, W] float in [0, 1] -> LineSegments.

    grad_threshold: minimum gradient magnitude for a pixel to be usable
    (the reference's rho = 2/sin(tau) quantization bound, expressed on
    [0,1] images). nfa_eps: keep segments with -log10(NFA) > nfa_eps
    (the reference's log_eps, default 0). A tensor keeps its device;
    numpy goes to `device` (default the card).
    """
    global last_propagation_steps
    dev = resolve_device(device, like=images)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    if images.ndim == 2:
        images = images[None]
    b, h, w = images.shape
    tau = float(np.float32(np.deg2rad(tau_deg)))
    ang, mag = _level_lines(images)
    usable = mag > grad_threshold

    # ---- connected components of mutually aligned pixels --------------
    labels, last_propagation_steps = _components(ang, usable, tau)

    # ---- per-component moments via scatter-add ------------------------
    # about each component's own label pixel (its first pixel, x0, y0):
    # the second moments m = s/w - c^2 then cancel at the component's
    # extent, not at the distance from the image origin
    n = h * w
    lab_flat = torch.clamp(labels.reshape(b, -1), 0, n - 1).long()
    on = (labels < _NO_LABEL).reshape(b, -1).to(torch.float32)
    wgt = mag.reshape(b, -1) * on
    pix = torch.arange(n, device=dev)
    dx = ((pix % w)[None] - lab_flat % w).to(torch.float32)
    dy = ((pix // w)[None] - lab_flat // w).to(torch.float32)
    cnt = _seg_sum(lab_flat, on, n)                  # pixels per component
    sw = _seg_sum(lab_flat, wgt, n)
    sx = _seg_sum(lab_flat, wgt * dx, n)
    sy = _seg_sum(lab_flat, wgt * dy, n)
    sxx = _seg_sum(lab_flat, wgt * dx * dx, n)
    syy = _seg_sum(lab_flat, wgt * dy * dy, n)
    sxy = _seg_sum(lab_flat, wgt * dx * dy, n)

    # top components by pixel count (tie-exact: the lower label first,
    # as lax.top_k), clamped to the candidate count for tiny images
    score = torch.where(cnt >= min_pixels, cnt, 0.0)
    k_eff = min(max_segments, n)
    top_c, comp = top_k_largest(score, k_eff)            # [B, L]
    if k_eff < max_segments:
        pad = max_segments - k_eff
        top_c = torch.nn.functional.pad(top_c, (0, pad))
        comp = torch.nn.functional.pad(comp, (0, pad))

    def take(a):
        return torch.gather(a, 1, comp)
    n_pix = take(cnt)
    swc_safe = torch.clamp_min(take(sw), 1e-9)
    ux = take(sx) / swc_safe                     # center about (x0, y0)
    uy = take(sy) / swc_safe
    cx = (comp % w).to(torch.float32) + ux
    cy = (comp // w).to(torch.float32) + uy
    # second moments about the center (region2rect)
    mxx = take(sxx) / swc_safe - ux * ux
    myy = take(syy) / swc_safe - uy * uy
    mxy = take(sxy) / swc_safe - ux * uy
    # principal axis angle of the smallest-eigenvalue-normal direction
    theta = 0.5 * torch.atan2(2.0 * mxy, mxx - myy)
    lam = torch.sqrt(torch.clamp_min(
        0.25 * (mxx - myy) ** 2 + mxy ** 2, 0.0))
    half = 0.5 * (mxx + myy)
    l_var = half + lam                       # along-axis variance
    w_var = torch.clamp_min(half - lam, 0.0)  # across-axis variance
    length = 2.0 * torch.sqrt(torch.clamp_min(3.0 * l_var, 0.0))
    width = torch.clamp_min(
        2.0 * torch.sqrt(torch.clamp_min(3.0 * w_var, 0.0)), 1.0)
    ct, st = torch.cos(theta), torch.sin(theta)
    x1 = cx - 0.5 * length * ct
    y1 = cy - 0.5 * length * st
    x2 = cx + 0.5 * length * ct
    y2 = cy + 0.5 * length * st

    # ---- NFA validation (log domain) ----------------------------------
    # rectangle trial count (N*M)^{5/2} * 11 orientations; aligned
    # points k = component size, total n = rectangle area
    p = float(np.float32(tau_deg / 180.0))
    n_rect = torch.maximum(length * width, n_pix)
    k = n_pix
    # log10 of P[Bin(n, p) >= k] upper bound via the largest term times
    # (n - k + 1) (the reference uses the same hoeffding-style term bound
    # inside nfa())
    n_rect = torch.maximum(n_rect, k)
    log_c = (torch.lgamma(n_rect + 1.0) - torch.lgamma(k + 1.0)
             - torch.lgamma(n_rect - k + 1.0))
    log_term = (log_c + k * float(np.log(np.float32(p)))
                + (n_rect - k) * float(np.log1p(-np.float32(p))))
    log_tail = ((log_term + torch.log(n_rect - k + 1.0))
                / float(np.log(np.float32(10.0))))
    log_trials = float(np.float32(2.5) * np.log10(np.float32(h * w))
                       + np.log10(np.float32(11.0)))
    neg_log_nfa = -(log_trials + log_tail)
    valid = (n_pix >= min_pixels) & (neg_log_nfa > nfa_eps) & (top_c > 0)

    segs = torch.stack([x1, y1, x2, y2], -1)
    zero = torch.zeros_like(theta)
    return LineSegments(
        segments=torch.where(valid[..., None], segs, 0.0),
        width=torch.where(valid, width, zero),
        angle=torch.where(valid, theta, zero),
        nfa=torch.where(valid, neg_log_nfa, zero),
        valid=valid)
