"""Image undistortion: batched inverse-warp resampling through the camera
models (counterpart of `cvt_tpu.apps.undistort`).

Reference: retrieval/vlindex/src/exe/image.cc:77-407 (image_undistorter:
per-image UndistortImage via Camera models + bilinear interpolation,
with blank-pixel / scale ROI selection in
base/undistortion.cc:UndistortCamera).

An output pixel grid is pushed through the FORWARD distortion of the
source camera (pixel -> normalized pinhole ray -> distorted source
pixel; no iterative inverse needed for this direction) and sampled by
one bilinear sampler (`_bilinear`) for every image and channel at once:
four gathers, each tap checked for bounds on its own, weights summed in
`jax.scipy.ndimage.map_coordinates(order=1, mode="constant", cval=0)`'s
order. `undistort_camera` stays host numpy, as in `cvt_tpu`.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.match.cameras import (_distort, _focal_principal,
                                         image_to_world)
from cvt_tpu_torch.utils.device import resolve_device


def undistort_camera(model: str, params, width: int, height: int, *,
                     blank_pixels: float = 0.0):
    """Pinhole params (fx, fy, cx, cy) for the undistorted output camera.

    blank_pixels in [0, 1] interpolates between max_scale (0: no blank
    corners — the undistorted frame is cropped to valid source pixels)
    and min_scale (1: every source pixel visible, corners blank) — the
    reference's UndistortCameraOptions.blank_pixels semantics
    (base/undistortion.cc). The focal is scaled accordingly; the
    principal point is preserved. Host arithmetic (CPU tensors).
    """
    params = np.asarray(params, np.float32)
    pt = torch.from_numpy(params.copy())
    f, c = _focal_principal(model, pt[None, :])
    f = f[0].numpy()
    c = c[0].numpy()
    if model in ("simple_pinhole", "pinhole"):
        return np.array([f[0], f[1], c[0], c[1]], np.float32)
    # probe the frame border (true normalized extent of the image) and
    # measure the distortion's radial stretch there; the output focal
    # scale that exactly crops/covers the border follows from it.
    x0, x1 = (0.0 - c[0]) / f[0], (width - 1.0 - c[0]) / f[0]
    y0, y1 = (0.0 - c[1]) / f[1], (height - 1.0 - c[1]) / f[1]
    tx = np.linspace(x0, x1, 65, dtype=np.float32)
    ty = np.linspace(y0, y1, 65, dtype=np.float32)
    border = np.concatenate([
        np.stack([tx, np.full_like(tx, y0)], -1),
        np.stack([tx, np.full_like(tx, y1)], -1),
        np.stack([np.full_like(ty, x0), ty], -1),
        np.stack([np.full_like(ty, x1), ty], -1)], 0)
    d = _distort(model, pt[None, None, :],
                 torch.from_numpy(border)[None, :, :])[0].numpy()
    # radial gain of the distortion at the border (distorted radius per
    # undistorted radius)
    rn = np.linalg.norm(border, axis=-1)
    rd = np.linalg.norm(d, axis=-1)
    gain = rd / np.maximum(rn, 1e-6)
    s_min, s_max = float(gain.min()), float(gain.max())
    s = s_max + (s_min - s_max) * float(np.clip(blank_pixels, 0.0, 1.0))
    return np.array([f[0] * s, f[1] * s, c[0], c[1]], np.float32)


def _bilinear(images, sv, su):
    """Sample images [B, H, W, C] at (row sv, column su) [...]: bilinear,
    each of the 4 taps outside the frame contributing 0, the weighted
    taps summed in the order (y0,x0), (y0,x1), (y1,x0), (y1,x1).
    Returns [B, ..., C]."""
    b, h, w, c = images.shape
    flat = images.reshape(b, h * w, c)
    shape = sv.shape
    y0f, x0f = torch.floor(sv), torch.floor(su)
    wy1, wx1 = sv - y0f, su - x0f
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    y0, x0 = y0f.to(torch.int64), x0f.to(torch.int64)
    out = None
    for yi, wy in ((y0, wy0), (y0 + 1, wy1)):
        for xi, wx in ((x0, wx0), (x0 + 1, wx1)):
            ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
            idx = torch.where(ok, yi * w + xi, 0).reshape(-1)
            tap = flat[:, idx, :].reshape((b,) + shape + (c,))
            tap = torch.where(ok[..., None], tap, 0.0)
            term = (wy * wx)[..., None] * tap
            out = term if out is None else out + term
    return out


def _sample(image, sv, su):
    """One image [H, W] or [H, W, C] at (sv, su) [h, w]."""
    if image.ndim == 2:
        return _bilinear(image[None, ..., None], sv, su)[0, ..., 0]
    return _bilinear(image[None], sv, su)[0]


def _grid(h: int, w: int, device):
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing="ij")
    return vv, uu


def _source_pixels(model, params, new_params, h_out: int, w_out: int):
    """Each output pixel of the pinhole camera new_params, through the
    source camera's forward distortion -> source (sv, su) [h_out, w_out]."""
    fx, fy, cx, cy = (new_params[0], new_params[1], new_params[2],
                      new_params[3])
    vv, uu = _grid(h_out, w_out, params.device)
    # output pixel -> ideal pinhole ray
    x = (uu - cx) / fx
    y = (vv - cy) / fy
    xy = torch.stack([x, y], -1).reshape(1, -1, 2)
    # forward distortion -> source pixel coordinates
    f, c = _focal_principal(model, params[None, None, :])
    src = _distort(model, params[None, None, :], xy) * f + c   # [1, N, 2]
    return (src[0, :, 1].reshape(h_out, w_out),
            src[0, :, 0].reshape(h_out, w_out))


def undistort_images(images, model: str, params, *,
                     blank_pixels: float = 0.0,
                     out_shape: tuple[int, int] | None = None,
                     device=None):
    """Undistort a batch of images [B, H, W(, C)] through one camera.

    Returns (undistorted [B, h, w(, C)] float32 on the device, new_params
    [4] float32 numpy pinhole (fx, fy, cx, cy)). Mirrors exe/image.cc's
    ImageUndistorter loop; every image and channel goes through one
    sampling pass. `device`: the card unless the caller asks for the CPU
    (device="cpu" or CPU tensors).
    """
    dev = resolve_device(device, like=images)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    params_np = np.asarray(torch.as_tensor(params).cpu(), np.float32)
    h, w = images.shape[1], images.shape[2]
    h_out, w_out = out_shape if out_shape is not None else (h, w)
    newp = undistort_camera(model, params_np, w, h,
                            blank_pixels=blank_pixels)
    sv, su = _source_pixels(model, torch.from_numpy(params_np).to(dev),
                            torch.from_numpy(newp).to(dev), h_out, w_out)
    if images.ndim == 3:
        return _bilinear(images[..., None], sv, su)[..., 0], newp
    return _bilinear(images, sv, su), newp


def warp_image_homography(image, h_mat, h_out: int, w_out: int,
                          device=None):
    """Warp with a 3x3 homography H mapping TARGET pixel -> SOURCE pixel
    (base/warp.cc WarpImageWithHomography): bilinear inverse warp.
    image [H, W] or [H, W, C]."""
    dev = resolve_device(device, like=image)
    image = torch.as_tensor(image, dtype=torch.float32, device=dev)
    h_mat = torch.as_tensor(h_mat, dtype=torch.float32, device=dev)
    vv, uu = _grid(h_out, w_out, dev)
    pts = torch.stack([uu, vv, torch.ones_like(uu)])           # [3, h, w]
    p = torch.sum(h_mat[:, :, None, None] * pts[None], 1)
    return _sample(image, p[1] / p[2], p[0] / p[2])


def warp_between_cameras(image, src_model: str, src_params,
                         dst_model: str, dst_params, device=None):
    """Resample `image` taken by the source camera as if taken by the
    target camera (base/warp.cc WarpImageBetweenCameras): target pixel
    -> target-normalized ray (iterative undistortion) -> source
    distortion -> source pixel -> bilinear sample."""
    dev = resolve_device(device, like=image)
    image = torch.as_tensor(image, dtype=torch.float32, device=dev)
    h, w = image.shape[:2]
    vv, uu = _grid(h, w, dev)
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1)
    xy = image_to_world(dst_model, torch.as_tensor(
        dst_params, dtype=torch.float32, device=dev), uv)
    sp = torch.as_tensor(src_params, dtype=torch.float32, device=dev)
    f, c = _focal_principal(src_model, sp[None, None, :])
    src = _distort(src_model, sp[None, None, :], xy[None]) * f + c
    return _sample(image, src[0, :, 1].reshape(h, w),
                   src[0, :, 0].reshape(h, w))
