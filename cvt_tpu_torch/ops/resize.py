"""`jax.image.resize(method="linear")` as two matrix products.

JAX resizes through `scale_and_translate` with a triangle kernel and
antialiasing on: when an axis shrinks, the kernel is widened by the
scale, so each output pixel averages every input pixel under the
stretched triangle (not the 2x2 neighbourhood of bilinear sampling).
`F.interpolate(antialias=True)` computes its weights otherwise, so the
port builds JAX's [out, in] weight matrix per axis (float32, as JAX
does) and applies one product per resized axis. An axis whose size does
not change is left alone, as in JAX. Used by `features/embedding.py`'s
`preprocess` and `apps/phash.py`'s `resize_gray_32`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 weights of JAX's antialiased linear resize
    (`jax._src.image.scale.compute_weight_mat` with the triangle kernel)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))      # Python floats, then f32
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = np.sum(w, axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.ascontiguousarray(
        np.where(inside[None, :], w, f32(0.0)).astype(f32).T)


def resize_linear(x: torch.Tensor, shape: tuple) -> torch.Tensor:
    """x [...] float32 -> `shape` (same rank), resized along every axis
    whose size changes, as `jax.image.resize(x, shape, "linear")`."""
    if len(shape) != x.ndim:
        raise ValueError(f"shape {shape} has not the rank of {x.shape}")
    for d, n_out in enumerate(shape):
        n_in = x.shape[d]
        if n_in == n_out:
            continue
        w = torch.from_numpy(linear_weights(n_in, int(n_out))).to(x.device)
        x = torch.movedim(torch.movedim(x, d, -1) @ w.T, -1, d)
    return x
