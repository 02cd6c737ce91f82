"""Gaussian scale-space pyramid + DoG, batched over images (counterpart of
`cvt_tpu.features.scale_space`).

Reference: VLFeat's covdet scale space (covdet/3rd/VLFeat/vl/scalespace.c,
driven by covdet/vl_covdet.hpp:73-140 with doubleImage=first_octave -1)
and vlindex SIFT options (retrieval/vlindex/src/feature/sift.h:59-84:
first_octave=-1, octave_resolution 3, peak 0.02/3, edge 10).

Every Gaussian level is a separable convolution of a [B, H, W] batch
(`F.conv2d` over edge-replicated padding); octaves are a Python loop over
halving shapes. The convolutions run with TF32 off: cuDNN allows it by
default, and its 10-bit mantissa would move the DoG extrema.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from cvt_tpu_torch.ops.linalg import full_precision_conv
from cvt_tpu_torch.utils.device import resolve_device


class OctavePyramid(NamedTuple):
    """One octave: gauss [B, S+3, H, W], dog [B, S+2, H, W],
    grad_dx/grad_dy [B, S+3, H, W], octave index (int), step (pixel size
    of this octave in input-image pixels, e.g. 0.5 for octave -1)."""
    gauss: torch.Tensor
    dog: torch.Tensor
    grad_dx: torch.Tensor
    grad_dy: torch.Tensor
    octave: int
    step: float
    sigmas: tuple  # per-level absolute sigma in input-image pixels


def _gauss_kernel1d(sigma: float) -> np.ndarray:
    r = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur on [B, H, W] with edge-replicate padding."""
    if sigma <= 0:
        return x
    k = torch.from_numpy(_gauss_kernel1d(sigma)).to(x.device)
    r = (k.numel() - 1) // 2
    x4 = x[:, None]                                              # [B,1,H,W]
    with full_precision_conv():
        x4 = F.conv2d(F.pad(x4, (r, r, 0, 0), mode="replicate"),
                      k.reshape(1, 1, 1, -1))
        x4 = F.conv2d(F.pad(x4, (0, 0, r, r), mode="replicate"),
                      k.reshape(1, 1, -1, 1))
    return x4[:, 0]


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """`jax.image.resize(..., "linear")` to twice the size: half-pixel
    centres, borders clamped."""
    return F.interpolate(x[:, None], scale_factor=2, mode="bilinear",
                         align_corners=False, antialias=False)[:, 0]


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    return x[:, ::2, ::2]


def _gradients(levels: torch.Tensor):
    """Central-difference gradients of [B, S, H, W] along W (dx) and H (dy)."""
    dx = 0.5 * (torch.roll(levels, -1, 3) - torch.roll(levels, 1, 3))
    dy = 0.5 * (torch.roll(levels, -1, 2) - torch.roll(levels, 1, 2))
    # zero out the wrapped borders
    dx[..., 0] = 0.0
    dx[..., -1] = 0.0
    dy[..., 0, :] = 0.0
    dy[..., -1, :] = 0.0
    return dx, dy


def _build(images, n_octaves, n_scales, first_octave, sigma0,
           with_gradients):
    s = n_scales
    base = images
    if first_octave == -1:
        base = _upsample2(base)
    # assumed input blur 0.5 px (VLFeat convention), scaled by upsampling
    cur_sigma = 0.5 * (2.0 if first_octave == -1 else 1.0)
    # bring base to sigma0 in octave units (octave pixel = 1)
    if sigma0 > cur_sigma:
        base = _blur(base, math.sqrt(sigma0 ** 2 - cur_sigma ** 2))
    octaves = []
    for _ in range(n_octaves):
        levels = [base]
        sig_prev = sigma0
        for li in range(1, s + 3):
            sig = sigma0 * (2.0 ** (li / s))
            inc = math.sqrt(max(sig ** 2 - sig_prev ** 2, 1e-12))
            levels.append(_blur(levels[-1], inc))
            sig_prev = sig
        gauss = torch.stack(levels, 1)                           # [B,S+3,H,W]
        dog = gauss[:, 1:] - gauss[:, :-1]                       # [B,S+2,H,W]
        if with_gradients:
            dx, dy = _gradients(gauss)
        else:
            dx = dy = gauss[:, :0]
        octaves.append((gauss, dog, dx, dy))
        base = _downsample2(levels[s])      # sigma doubled at level S
    return octaves


def build_pyramid(images, *, n_scales: int = 3, first_octave: int = -1,
                  sigma0: float = 1.6, max_octaves: int = 8,
                  with_gradients: bool = True,
                  device=None) -> list[OctavePyramid]:
    """images [B, H, W] float in [0, 1] -> list of OctavePyramid.

    first_octave=-1 doubles the image first (the reference default,
    vl_covdet.hpp:87 doubleImage / sift.h first_octave=-1). Tensors stay
    on their device; numpy goes to `device` (default the card)."""
    dev = resolve_device(device, like=images)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    b, h, w = images.shape
    size = min(h, w) * (2 if first_octave == -1 else 1)
    n_octaves = 0
    while size >= 16 and n_octaves < max_octaves:
        n_octaves += 1
        size //= 2
    raw = _build(images, n_octaves, n_scales, first_octave, sigma0,
                 with_gradients)
    out = []
    for o, (gauss, dog, dx, dy) in enumerate(raw):
        oct_idx = o + first_octave
        step = 2.0 ** oct_idx
        sigmas = tuple(sigma0 * (2.0 ** (oct_idx + li / n_scales))
                       for li in range(n_scales + 3))
        out.append(OctavePyramid(gauss, dog, dx, dy, oct_idx, step, sigmas))
    return out
