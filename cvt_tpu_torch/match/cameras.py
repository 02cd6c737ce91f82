"""Camera models: project / unproject with distortion, fully batched
(counterpart of `cvt_tpu.match.cameras`).

Reference: vlindex/src/base/camera_models.h — COLMAP's 10 camera models
expose WorldToImage / ImageToWorld per model with distortion handled by
an iterative undistort. Here each model is a pair of functions over
[..., 2] point tensors; undistortion is a fixed-iteration Newton loop
(no data-dependent control flow, no host read) over every point at once.

Params layout (trailing axis of `params`), matching COLMAP's ordering:
  pinhole               : fx, fy, cx, cy
  simple_pinhole        : f, cx, cy
  simple_radial         : f, cx, cy, k
  radial                : f, cx, cy, k1, k2
  opencv                : fx, fy, cx, cy, k1, k2, p1, p2
  full_opencv           : fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6
  opencv_fisheye        : fx, fy, cx, cy, k1, k2, k3, k4
  fov                   : fx, fy, cx, cy, omega
  simple_radial_fisheye : f, cx, cy, k
  radial_fisheye        : f, cx, cy, k1, k2
  thin_prism_fisheye    : fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1

For the fisheye family the equidistant theta-mapping is folded into the
distortion map, so the one generic Newton loop inverts the full model.
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.match.solvers import _f32

MODELS = ("simple_pinhole", "pinhole", "simple_radial", "radial", "opencv",
          "full_opencv", "opencv_fisheye", "fov", "simple_radial_fisheye",
          "radial_fisheye", "thin_prism_fisheye")

_NEWTON_ITERS = 10
_EPS = 1e-8


def _focal_principal(model: str, params):
    if model in ("simple_pinhole", "simple_radial", "radial",
                 "simple_radial_fisheye", "radial_fisheye"):
        f = params[..., 0:1]
        return torch.cat([f, f], -1), params[..., 1:3]
    # fx, fy, cx, cy family
    return params[..., 0:2], params[..., 2:4]


def _fisheye_scale(xy):
    """Equidistant fisheye mapping factor: theta/r (==1 at r->0)."""
    r2 = torch.sum(xy * xy, -1)
    r = torch.sqrt(torch.clamp_min(r2, _EPS * _EPS))
    theta = torch.atan(r)
    return torch.where(r2 > _EPS * _EPS, theta / r, 1.0), theta


def _distort(model: str, params, xy):
    """Apply the model's distortion to normalized coords xy [..., n, 2]."""
    if model in ("simple_pinhole", "pinhole"):
        return xy
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    if model == "simple_radial":
        radial = 1.0 + params[..., 3] * r2
        return xy * radial[..., None]
    if model == "radial":
        k1, k2 = params[..., 3], params[..., 4]
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        return xy * radial[..., None]
    if model == "opencv":
        k1, k2 = params[..., 4], params[..., 5]
        p1, p2 = params[..., 6], params[..., 7]
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        dy = (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return torch.stack([x * radial + dx, y * radial + dy], -1)
    if model == "full_opencv":
        k1, k2 = params[..., 4], params[..., 5]
        p1, p2 = params[..., 6], params[..., 7]
        k3, k4 = params[..., 8], params[..., 9]
        k5, k6 = params[..., 10], params[..., 11]
        r4, r6 = r2 * r2, r2 * r2 * r2
        radial = ((1.0 + k1 * r2 + k2 * r4 + k3 * r6)
                  / (1.0 + k4 * r2 + k5 * r4 + k6 * r6))
        dx = (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x))
        dy = (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y)
        return torch.stack([x * radial + dx, y * radial + dy], -1)
    if model == "fov":
        # camera_models.h FOVCameraModel: rd = atan(2 r tan(w/2)) / w
        omega = params[..., 4]
        r = torch.sqrt(torch.clamp_min(r2, _EPS * _EPS))
        num = torch.atan(2.0 * r * torch.tan(0.5 * omega))
        # signed safe denominator: the model is even in omega and the
        # reference divides by signed omega (negative omega is valid)
        safe_w = torch.where(torch.abs(omega) > _EPS, omega, 1.0)
        factor = torch.where(
            (r2 > _EPS * _EPS) & (torch.abs(omega) > _EPS),
            num / (safe_w * r), 1.0)
        return xy * factor[..., None]
    if model in ("opencv_fisheye", "simple_radial_fisheye",
                 "radial_fisheye"):
        scale, theta = _fisheye_scale(xy)
        t2 = theta * theta
        if model == "opencv_fisheye":
            k1, k2 = params[..., 4], params[..., 5]
            k3, k4 = params[..., 6], params[..., 7]
            poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        elif model == "simple_radial_fisheye":
            poly = 1.0 + params[..., 3] * t2
        else:  # radial_fisheye
            poly = 1.0 + t2 * (params[..., 3] + t2 * params[..., 4])
        return xy * (scale * poly)[..., None]
    if model == "thin_prism_fisheye":
        scale, _ = _fisheye_scale(xy)
        u, v = x * scale, y * scale
        k1, k2 = params[..., 4], params[..., 5]
        p1, p2 = params[..., 6], params[..., 7]
        k3, k4 = params[..., 8], params[..., 9]
        sx1, sy1 = params[..., 10], params[..., 11]
        q2 = u * u + v * v
        radial = q2 * (k1 + q2 * (k2 + q2 * (k3 + q2 * k4)))
        du = (u * radial + 2.0 * p1 * u * v + p2 * (q2 + 2.0 * u * u)
              + sx1 * q2)
        dv = (v * radial + 2.0 * p2 * u * v + p1 * (q2 + 2.0 * v * v)
              + sy1 * q2)
        return torch.stack([u + du, v + dv], -1)
    raise ValueError(f"unknown camera model {model!r}")


def world_to_image(model: str, params, xy) -> torch.Tensor:
    """Normalized camera coords [..., n, 2] -> pixel coords [..., n, 2].

    `params` broadcasts over the leading axes (one camera or a batch).
    Tensors stay on their device; numpy goes to the device of the other
    argument when it is a tensor, else to the card.
    """
    xy = _f32(xy, params)
    params = _f32(params, xy)[..., None, :]                   # over n
    f, c = _focal_principal(model, params)
    return _distort(model, params, xy) * f + c


def image_to_world(model: str, params, uv) -> torch.Tensor:
    """Pixel coords [..., n, 2] -> normalized camera coords [..., n, 2].

    Distortion inverted by _NEWTON_ITERS fixed Newton steps on the 2x2
    Jacobian of the distortion map, matching COLMAP's
    IterativeUndistortion with a static iteration count. The Jacobian's
    two columns come from one vmapped forward-mode pass over all points
    (the map is pointwise, so a unit tangent in x, then in y, gives each
    point's columns: what `jax.vmap(jax.jacfwd(...))` computes), and each
    step solves (J + 1e-9 I) s = r in closed form (Cramer's rule on the
    2x2 block: no batched LU, no host read).
    """
    uv = _f32(uv, params)
    params = _f32(params, uv)[..., None, :]
    f, c = _focal_principal(model, params)
    xy = (uv - c) / f
    if model in ("simple_pinhole", "pinhole"):
        return xy
    params = params.expand(xy.shape[:-1] + params.shape[-1:])
    target = xy
    # unit tangents in x, then in y, on every point: [2, ..., 2]
    units = torch.eye(2, dtype=xy.dtype, device=xy.device).reshape(
        (2,) + (1,) * (xy.ndim - 1) + (2,)).expand((2,) + xy.shape)

    def columns(p):
        return torch.func.vmap(lambda t: torch.func.jvp(
            lambda q: _distort(model, params, q), (p,), (t,)))(units)

    p = target
    for _ in range(_NEWTON_ITERS):
        d, (jx, jy) = columns(p)                      # columns d/dx, d/dy
        r = d[0] - target
        a, c_ = jx[..., 0] + 1e-9, jx[..., 1]
        b, d_ = jy[..., 0], jy[..., 1] + 1e-9
        det = a * d_ - b * c_
        sx = (d_ * r[..., 0] - b * r[..., 1]) / det
        sy = (a * r[..., 1] - c_ * r[..., 0]) / det
        p = p - torch.stack([sx, sy], -1)
    return p


def calibration_matrix(model: str, params) -> torch.Tensor:
    """K [..., 3, 3] from intrinsic params (distortion excluded)."""
    params = _f32(params)
    f, c = _focal_principal(model, params[..., None, :])
    f, c = f[..., 0, :], c[..., 0, :]
    k = torch.zeros(params.shape[:-1] + (3, 3), dtype=torch.float32,
                    device=params.device)
    k[..., 0, 0] = f[..., 0]
    k[..., 1, 1] = f[..., 1]
    k[..., 0, 2] = c[..., 0]
    k[..., 1, 2] = c[..., 1]
    k[..., 2, 2] = 1.0
    return k
