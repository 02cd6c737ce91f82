"""Affine shape adaptation: second-moment-matrix iteration per keypoint
(counterpart of `cvt_tpu.features.affine`).

Reference: vl_covdet_extract_affine_shape as driven by
covdet/vl_covdet.hpp:159-173 (the Baumberg/Mikolajczyk iteration VLFeat
implements in covdet.c): iterate  A <- A * M^{-1/2}  where M is the
windowed second-moment (structure tensor) of the image gradients sampled
through the current A, until the normalized patch is isotropic (M ~ I).
The resulting unit-determinant A maps the unit circle to the feature's
ellipse; descriptors sample through R(angle) * A.

A fixed number of iterations of a closed-form 2x2 inverse square root,
batched over every keypoint (non-converging features keep their last
iterate, as in `cvt_tpu`).
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.features.descriptor import (_Sampler, _image_rows,
                                               _interleave, _one_octave,
                                               _rows)


def _inv_sqrt_2x2(m11, m12, m22, eps=1e-12):
    """Closed-form inverse square root of an SPD 2x2 [[a,b],[b,c]]:
    sqrt(M) = (M + s I) / t with s = sqrt(det M), t = sqrt(tr M + 2 s);
    the inverse follows from the 2x2 adjugate."""
    det = torch.clamp_min(m11 * m22 - m12 * m12, eps)
    s = torch.sqrt(det)
    t = torch.sqrt(torch.clamp_min(m11 + m22 + 2.0 * s, eps))
    # sqrt(M) entries
    r11 = (m11 + s) / t
    r12 = m12 / t
    r22 = (m22 + s) / t
    rdet = torch.clamp_min(r11 * r22 - r12 * r12, eps)
    return r22 / rdet, -r12 / rdet, r11 / rdet


def estimate_affine_shape(dx, dy, x, y, sigma_oct, level, valid, *,
                          n_samples: int = 16, iters: int = 5):
    """Per-keypoint affine shape A [B, K, 2, 2], det(A) = 1.

    dx/dy [B, L, H, W] octave gradient fields; x/y [B, K] octave coords;
    sigma_oct [B, K]; level [B, K] int. A maps normalized (isotropic)
    patch coordinates to image coordinates; identity for invalid slots.
    """
    b, k = x.shape
    dev = x.device
    p = n_samples
    lin = np.linspace(-1.0, 1.0, p, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    grid = torch.from_numpy(np.stack([gx.ravel(), gy.ravel()], 1)).to(dev)
    r2 = grid[:, 0] ** 2 + grid[:, 1] ** 2
    wgt = torch.exp(-r2 / (2.0 * 0.5 ** 2)) * (r2 <= 1.0)
    win_r = 3.0
    sample = _Sampler(_interleave(dx, dy), *_one_octave(dx))
    bi = _image_rows(b, k, dev)
    oi = torch.zeros_like(bi)
    xr, yr, lr = _rows(x), _rows(y), _rows(level).long()
    sw = (win_r * _rows(sigma_oct))[:, None]
    u, v = grid[:, 0] * sw, grid[:, 1] * sw                      # [N, P^2]
    a = torch.eye(2, dtype=torch.float32, device=dev).repeat(b * k, 1, 1)
    for _ in range(iters):
        # sample gradients through the current shape
        c = a[:, :, :, None]
        px = c[:, 0, 0] * u + c[:, 0, 1] * v
        py = c[:, 1, 0] * u + c[:, 1, 1] * v
        vx, vy = sample(bi, oi, lr, xr[:, None] + px, yr[:, None] + py)
        # gradients in the normalized frame: g' = A^T g
        g1 = c[:, 0, 0] * vx + c[:, 1, 0] * vy
        g2 = c[:, 0, 1] * vx + c[:, 1, 1] * vy
        m11 = torch.sum(wgt * g1 * g1, -1)
        m12 = torch.sum(wgt * g1 * g2, -1)
        m22 = torch.sum(wgt * g2 * g2, -1)
        tr = m11 + m22
        ok = tr > 1e-12
        scale = torch.where(ok, 2.0 / torch.clamp_min(tr, 1e-12), 1.0)
        m11n = torch.where(ok, m11 * scale, 1.0)
        m12n = torch.where(ok, m12 * scale, 0.0)
        m22n = torch.where(ok, m22 * scale, 1.0)
        i11, i12, i22 = _inv_sqrt_2x2(m11n, m12n, m22n)
        a_new = torch.stack([
            torch.stack([a[:, 0, 0] * i11 + a[:, 0, 1] * i12,
                         a[:, 0, 0] * i12 + a[:, 0, 1] * i22], -1),
            torch.stack([a[:, 1, 0] * i11 + a[:, 1, 1] * i12,
                         a[:, 1, 0] * i12 + a[:, 1, 1] * i22], -1),
        ], -2)
        # renormalize to unit determinant (shape only; scale lives in sigma)
        d = torch.abs(a_new[:, 0, 0] * a_new[:, 1, 1]
                      - a_new[:, 0, 1] * a_new[:, 1, 0])
        a_new = a_new / torch.sqrt(torch.clamp_min(d, 1e-12))[:, None, None]
        bad = ~torch.all(torch.isfinite(a_new).reshape(-1, 4), -1)
        a = torch.where(bad[:, None, None], a, a_new)
    eye = torch.eye(2, dtype=torch.float32, device=dev)
    return torch.where(valid[..., None, None], a.reshape(b, k, 2, 2), eye)
