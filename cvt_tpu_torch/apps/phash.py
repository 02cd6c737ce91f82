"""64-bit DCT perceptual hash + Hamming matching (counterpart of
`cvt_tpu.apps.phash`).

Reference: image_hash/pHash.hpp — 32x32 grayscale DCT, 8x8 low-frequency
block starting at offset `cons` (0 = normal, 15 = high-frequency variant,
pHash.hpp:21-62), bits = coefficient > mean, popcount Hamming distance
(:84-92), plus a "pure image" detector via dominant-gray-histogram ratio
(:95-119).

The DCT is two 32x32 products with the DCT-II basis, batched over
[B, 32, 32] images. A hash is one int64 word (bit i = coefficient i of
the block in row-major order), where `cvt_tpu` returns two uint32 words
[B, 2]: `ops.bits.sigs_to_u32` gives those words, and `hamming_distance`
takes either form. A coefficient within float32 rounding of its block's
mean may give the other bit than `cvt_tpu` (the products sum in another
order).
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.ops.bits import _hamming, _pack_bits, sigs_from_u32
from cvt_tpu_torch.ops.resize import resize_linear
from cvt_tpu_torch.utils.device import resolve_device


def _dct_basis(n: int = 32) -> np.ndarray:
    """Orthonormal DCT-II basis matrix [n, n] (rows = frequencies)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    b = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    b[0] *= 1.0 / np.sqrt(2.0)
    return (b * np.sqrt(2.0 / n)).astype(np.float32)


_BASIS = torch.from_numpy(_dct_basis(32))


def _gray(images, device) -> torch.Tensor:
    dev = resolve_device(device, like=images)
    return torch.as_tensor(images, dtype=torch.float32, device=dev)


def dct_block(images, cons: int = 0, *, device=None) -> torch.Tensor:
    """images [B, 32, 32] -> the hash's 64 DCT coefficients [B, 64]: the
    8x8 block at (1 + cons, 1 + cons), row-major."""
    x = _gray(images, device)
    basis = _BASIS.to(x.device)
    coef = basis @ x @ basis.T                                   # [B,32,32]
    return coef[:, 1 + cons:9 + cons, 1 + cons:9 + cons].reshape(-1, 64)


def phash(images, cons: int = 0, *, device=None) -> torch.Tensor:
    """images [B, 32, 32] float (any gray scale range) -> int64 [B]
    hashes, bit i = (coefficient i > the block's mean).

    cons: extra offset of the 8x8 coefficient block (reference uses 0,
    or 15 for the high-frequency variant). The block starts at
    (1+cons, 1+cons) — row/col 0 (the DC term and first AC row/col) are
    always skipped (pHash.hpp:35-36), which is what makes the hash
    invariant to global brightness shifts. A tensor keeps its device;
    numpy goes to `device` (default the card).
    """
    flat = dct_block(images, cons, device=device)
    return _pack_bits(flat > torch.mean(flat, -1, keepdim=True))


def _words(h, device) -> torch.Tensor:
    """int64 hashes [N], or `cvt_tpu`'s uint32 words [N, 2] -> int64 [N]."""
    if isinstance(h, torch.Tensor):
        return h if h.dtype == torch.int64 else torch.from_numpy(
            sigs_from_u32(h.cpu().numpy())).to(h.device)
    a = np.asarray(h)
    if a.ndim == 2 and a.shape[-1] == 2 and a.dtype == np.uint32:
        a = sigs_from_u32(a)
    return torch.as_tensor(a, dtype=torch.int64, device=device)


def hamming_distance(a, b, *, device=None) -> torch.Tensor:
    """a [N], b [M] hashes (int64, or uint32 word pairs [N, 2] / [M, 2])
    -> [N, M] int32 popcount(XOR)."""
    dev = resolve_device(device, like=a if isinstance(a, torch.Tensor)
                         else b)
    a, b = _words(a, dev), _words(b, dev)
    return _hamming(a[:, None], b[None, :])


def resize_gray_32(images, *, device=None) -> torch.Tensor:
    """[B, H, W] gray -> [B, 32, 32] by JAX's antialiased linear resize
    (`ops/resize.py`)."""
    x = _gray(images, device)
    return resize_linear(x, (x.shape[0], 32, 32))


def is_pure_image(images, ratio: float = 0.95, bins: int = 64, *,
                  device=None) -> torch.Tensor:
    """Detect near-constant images: True when the dominant gray histogram
    bin holds more than `ratio` of pixels (pHash.hpp:95-119). images
    [B, H, W] with values in [0, 255]. The histogram is an integer count
    (a scatter-add of ones), exactly `cvt_tpu`'s one-hot sum."""
    x = torch.clamp(_gray(images, device), 0.0, 255.0)
    b = torch.clamp((x / (256.0 / bins)).to(torch.int64), 0, bins - 1)
    b = b.reshape(x.shape[0], -1)
    hist = torch.zeros((x.shape[0], bins), dtype=torch.int64,
                       device=x.device).scatter_add_(1, b,
                                                     torch.ones_like(b))
    return (torch.amax(hist, -1).to(torch.float32) / b.shape[1]) > ratio
