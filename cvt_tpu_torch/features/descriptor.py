"""Orientation assignment + SIFT descriptor, batched over keypoints
(counterpart of `cvt_tpu.features.descriptor`).

Reference: VLFeat's per-feature patch pipeline as driven by
covdet/vl_covdet.hpp:159-247 (extract orientations, then
`vl_sift_calc_raw_descriptor` on polar gradients) and the classic Lowe
parameters (4x4 spatial bins x 8 orientations, Gaussian window,
0.2 clipping, 512 scaling); RootSIFT from
hnsw_sifts_retrieval/makeSIFTs.cpp:79-95 (L1 -> sqrt -> L2).

Every keypoint samples a FIXED PxP grid (scaled by its sigma, rotated by
its orientation) from its pyramid level's gradient fields by bilinear
gathers from one flat (dx, dy) stack; the 36-bin orientation histogram and
the [4, 4, 8] descriptor are soft one-hot products, as in `cvt_tpu`. The
keypoints are flattened to rows and processed in chunks, so the
[rows, P^2, 36] one-hot stays under `_CHUNK_ELEMS` elements whatever B and K
are. The per-octave functions run the same code over a one-octave stack.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cvt_tpu_torch.ops.topk import top_k_largest

N_ORI_BINS = 36
N_SPATIAL = 4     # 4x4 descriptor grid
N_ORI = 8
DESC_DIM = N_SPATIAL * N_SPATIAL * N_ORI  # 128
# elements of the largest per-chunk temporary ([rows, P^2, 36] float32)
_CHUNK_ELEMS = 1 << 26


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """img [H, W]; xs/ys [...] float coords -> sampled values [...].
    Out-of-bounds clamps (callers mask borders via weights)."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def _interleave(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """[B, ...] gradient fields -> [B, 2F] interleaved (dx, dy) pairs."""
    b = dx.shape[0]
    return torch.stack([dx.reshape(b, -1), dy.reshape(b, -1)], -1).reshape(
        b, -1)


def _one_octave(dx: torch.Tensor):
    """Octave metadata of a one-octave stack dx [B, L, H, W]."""
    _, _, h, w = dx.shape
    dev = dx.device
    return (torch.zeros(1, dtype=torch.int64, device=dev),
            torch.full((1,), h, dtype=torch.int64, device=dev),
            torch.full((1,), w, dtype=torch.int64, device=dev))


class _Sampler:
    """Bilinear (dx, dy) samples from a flat multi-octave stack gf [B, 2F]
    (interleaved pairs; octave o starts at pair base[o], has h[o] x w[o]
    pixels per level) for keypoint rows (image bi, octave oi, level li)."""

    def __init__(self, gf, base_arr, h_arr, w_arr):
        self.per_image = gf.shape[1] // 2
        self.g = gf.reshape(-1, 2)                     # [B*F, 2]
        dev = gf.device
        self.base = torch.as_tensor(base_arr, dtype=torch.int64, device=dev)
        self.h = torch.as_tensor(h_arr, dtype=torch.int64, device=dev)
        self.w = torch.as_tensor(w_arr, dtype=torch.int64, device=dev)

    def __call__(self, bi, oi, li, xs, ys):
        """bi/oi/li [N] int64; xs/ys [N, P^2] -> (vx, vy) [N, P^2]."""
        hv = self.h[oi][:, None]
        wv = self.w[oi][:, None]
        x0 = torch.minimum(torch.clamp_min(torch.floor(xs).to(torch.int64),
                                           0), wv - 2)
        y0 = torch.minimum(torch.clamp_min(torch.floor(ys).to(torch.int64),
                                           0), hv - 2)
        fx = torch.clamp(xs - x0, 0.0, 1.0)[..., None]
        fy = torch.clamp(ys - y0, 0.0, 1.0)[..., None]
        base = ((bi * self.per_image + self.base[oi])[:, None]
                + li[:, None] * (hv * wv) + y0 * wv + x0)
        top = (1 - fx) * self.g[base] + fx * self.g[base + 1]    # [N,P^2,2]
        bot = (1 - fx) * self.g[base + wv] + fx * self.g[base + wv + 1]
        v = (1 - fy) * top + fy * bot
        return v[..., 0], v[..., 1]


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[B, K, ...] -> [B*K, ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _chunks(n: int, per_row: int):
    c = max(1, _CHUNK_ELEMS // per_row)
    for s in range(0, n, c):
        yield slice(s, min(s + c, n))


def _image_rows(b: int, k: int, device) -> torch.Tensor:
    return torch.arange(b, device=device).repeat_interleave(k)


def _warp(xi, yi, u, v, m):
    """Sample positions xi + m @ (u, v) for rows [N] and grid [N, P^2];
    m [N, 2, 2] or None (identity: the same floats as multiplying by it)."""
    if m is None:
        return xi[:, None] + u, yi[:, None] + v
    m = m[:, :, :, None]
    return (xi[:, None] + m[:, 0, 0] * u + m[:, 0, 1] * v,
            yi[:, None] + m[:, 1, 0] * u + m[:, 1, 1] * v)


def _pull_back(vx, vy, m):
    """Gradients in the patch frame: m^T (vx, vy)."""
    if m is None:
        return vx, vy
    m = m[:, :, :, None]
    return (m[:, 0, 0] * vx + m[:, 1, 0] * vy,
            m[:, 0, 1] * vx + m[:, 1, 1] * vy)


def _soft_one_hot(binf: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[..., P] fractional bins -> [..., P, n_bins] linear-interpolation
    weights (jax.nn.one_hot of both neighbours)."""
    fl = torch.floor(binf)
    b0 = fl.to(torch.int64) % n_bins
    fb = (binf - fl)[..., None]
    bins = torch.arange(n_bins, device=binf.device)
    return ((b0[..., None] == bins) * (1 - fb)
            + (((b0 + 1) % n_bins)[..., None] == bins) * fb)


def _orientation_hist(g1, g2, wgt) -> torch.Tensor:
    """Patch-frame gradients [N, P^2] -> 36-bin histogram [N, 36],
    smoothed twice (VLFeat smooths 6x; 2 passes suffice here)."""
    mag = torch.sqrt(g1 * g1 + g2 * g2)
    ang = torch.atan2(g2, g1)
    binf = (ang + math.pi) / (2 * math.pi) * N_ORI_BINS
    contrib = mag * wgt
    hist = torch.matmul(contrib[:, None, :],
                        _soft_one_hot(binf, N_ORI_BINS))[:, 0]
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist
                + torch.roll(hist, -1, -1)) / 3.0
    return hist


def _peak_angles(hist, bins):
    """Parabolic interpolation around histogram bins [N, O] -> radians."""
    hl = torch.gather(hist, 1, (bins - 1) % N_ORI_BINS)
    hc = torch.gather(hist, 1, bins)
    hr = torch.gather(hist, 1, (bins + 1) % N_ORI_BINS)
    denom = hl - 2 * hc + hr
    off = torch.where(torch.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom, 0.0)
    off = torch.clamp(off, -0.5, 0.5)
    return ((bins + off + 0.5) / N_ORI_BINS) * 2 * math.pi - math.pi


def _orientation_peaks(hist, n_orientations: int, peak_ratio: float):
    """Histogram [N, 36] -> (angles [N, O], ok [N, O]): local maxima at or
    above peak_ratio x the maximum, best first (lax.top_k's tie order);
    slot 0 is valid wherever the histogram is not all zero."""
    hmax = torch.amax(hist, -1, keepdim=True)
    is_peak = ((hist >= torch.roll(hist, 1, -1))
               & (hist >= torch.roll(hist, -1, -1))
               & (hist >= peak_ratio * hmax) & (hmax > 0))
    score = torch.where(is_peak, hist, -1.0)
    vals, bins = top_k_largest(score, n_orientations)
    ok = vals > 0
    ok[:, 0] = hmax[:, 0] > 0
    return _peak_angles(hist, bins), ok


def _orientation_grid(p: int):
    """The orientation window: grid [P^2, 2] in units of its radius and
    the Gaussian weights [P^2]."""
    lin = np.linspace(-1.0, 1.0, p, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    grid = torch.from_numpy(np.stack([gx.ravel(), gy.ravel()], 1))
    win_r = 3.0 * 1.5
    r2 = (grid[:, 0] ** 2 + grid[:, 1] ** 2) * (win_r ** 2)
    wgt = torch.exp(-r2 / (2.0 * (1.5 * win_r / 2) ** 2))
    return grid, wgt, win_r


def _orientation_rows(sample, x, y, sigma_oct, level, oct_i, affine,
                      n_samples, fn):
    """Run fn(hist rows) over chunks of keypoint rows; returns the list of
    its per-chunk results in row order."""
    b, k = x.shape
    dev = x.device
    grid, wgt, win_r = _orientation_grid(n_samples)
    grid, wgt = grid.to(dev), wgt.to(dev)
    bi = _image_rows(b, k, dev)
    xr, yr, sr = _rows(x), _rows(y), _rows(sigma_oct)
    lr, orr = _rows(level).long(), _rows(oct_i).long()
    am = None if affine is None else _rows(affine)
    out = []
    for c in _chunks(b * k, grid.shape[0] * N_ORI_BINS):
        sw = (sr[c] * win_r)[:, None]
        xs, ys = _warp(xr[c], yr[c], sw * grid[:, 0], sw * grid[:, 1],
                       None if am is None else am[c])
        vx, vy = sample(bi[c], orr[c], lr[c], xs, ys)
        g1, g2 = _pull_back(vx, vy, None if am is None else am[c])
        out.append(fn(_orientation_hist(g1, g2, wgt)))
    return out


def assign_orientations_multi_flat(gf, base_arr, h_arr, w_arr, oct_i, x, y,
                                   sigma_oct, level, valid, *,
                                   n_samples: int = 16,
                                   n_orientations: int = 4,
                                   peak_ratio: float = 0.8, affine=None):
    """Up to n_orientations gradient-orientation peaks per keypoint over a
    flat multi-octave stack: gf [B, 2F] INTERLEAVED (dx, dy) gradients;
    oct_i [B, K] octave ids; x/y/sigma_oct in OCTAVE-LOCAL pixels; level
    [B, K] int. Returns (angles [B, K, O] radians, ok [B, K, O]).

    The reference DUPLICATES a feature once per orientation-histogram peak
    >= peak_ratio * max (vl_covdet_extract_orientations,
    covdet/vl_covdet.hpp:174-186; classic vl_sift convention 0.8)."""
    b, k = x.shape
    parts = _orientation_rows(
        _Sampler(gf, base_arr, h_arr, w_arr), x, y, sigma_oct, level, oct_i,
        affine, n_samples,
        lambda h: _orientation_peaks(h, n_orientations, peak_ratio))
    angs = torch.cat([a for a, _ in parts]).reshape(b, k, -1)
    ok = torch.cat([o for _, o in parts]).reshape(b, k, -1) & valid[..., None]
    return torch.where(ok, angs, 0.0), ok


def assign_orientations_multi(dx, dy, x, y, sigma_oct, level, valid, *,
                              n_samples: int = 16, n_orientations: int = 4,
                              peak_ratio: float = 0.8, affine=None):
    """assign_orientations_multi_flat for one octave: dx/dy [B, L, H, W]
    gradient fields; x/y/sigma_oct [B, K] octave coordinates."""
    return assign_orientations_multi_flat(
        _interleave(dx, dy), *_one_octave(dx), torch.zeros_like(level), x, y,
        sigma_oct, level, valid, n_samples=n_samples,
        n_orientations=n_orientations, peak_ratio=peak_ratio, affine=affine)


def assign_orientations(dx, dy, x, y, sigma_oct, level, valid, *,
                        n_samples: int = 16, affine=None):
    """Dominant gradient orientation per keypoint (the histogram's first
    maximum, parabolically refined).

    dx/dy [B, L, H, W] gradient fields (octave); x/y [B, K] octave
    coords; sigma_oct [B, K] scale in octave pixels; level [B, K] int.
    Returns angle [B, K] in radians (0 where not valid)."""
    b, k = x.shape
    parts = _orientation_rows(
        _Sampler(_interleave(dx, dy), *_one_octave(dx)), x, y, sigma_oct,
        level, torch.zeros_like(level), affine, n_samples,
        lambda h: _peak_angles(h, torch.argmax(h, -1, keepdim=True))[:, 0])
    return torch.where(valid, torch.cat(parts).reshape(b, k), 0.0)


def _descriptor_grid(p: int):
    """Descriptor sample grid [P^2, 2] in bin units, its Gaussian weights
    [P^2] and the static spatial soft-assignment [16, P^2]."""
    half = N_SPATIAL / 2.0
    lin = np.linspace(-half + half / p, half - half / p, p,
                      dtype=np.float32)    # bin-space sample centers
    gx, gy = np.meshgrid(lin, lin)
    grid = np.stack([gx.ravel(), gy.ravel()], 1)
    bin_centers = (np.arange(N_SPATIAL, dtype=np.float32)
                   - (N_SPATIAL - 1) / 2.0)
    # hat(y-bin) * hat(x-bin)
    gxn = np.stack([gx.ravel()] * N_SPATIAL, 0)
    wxb = np.maximum(0.0, 1.0 - np.abs(gxn - bin_centers[:, None]))
    gyn = np.stack([gy.ravel()] * N_SPATIAL, 0)
    wyb = np.maximum(0.0, 1.0 - np.abs(gyn - bin_centers[:, None]))
    w_spatial = (wyb[:, None, :] * wxb[None, :, :]).reshape(16, -1)
    grid = torch.from_numpy(grid)
    r2 = grid[:, 0] ** 2 + grid[:, 1] ** 2
    wgt = torch.exp(-r2 / (2.0 * (half ** 2)))
    return grid, wgt, torch.from_numpy(w_spatial.astype(np.float32))


def _normalize_clip(d: torch.Tensor) -> torch.Tensor:
    """normalize -> clip 0.2 -> renormalize (Lowe)."""
    d = d * torch.rsqrt(torch.sum(d * d, -1, keepdim=True) + 1e-12)
    d = torch.clamp_max(d, 0.2)
    return d * torch.rsqrt(torch.sum(d * d, -1, keepdim=True) + 1e-12)


def sift_descriptors_flat(gf, base_arr, h_arr, w_arr, oct_i, x, y,
                          sigma_oct, level, angle, valid, *,
                          n_samples: int = 16, magnif: float = 3.0,
                          affine=None):
    """128-d SIFT descriptors over a flat multi-octave stack (see
    assign_orientations_multi_flat): the window spans the 4x4 spatial
    bins, each magnif*sigma wide; `affine` [B, K, 2, 2] warps the grid
    through each keypoint's shape (gradients pulled back through the same
    transform). The spatial soft-assignment is static, so the [4, 4, 8]
    accumulation is one [16, P^2] x [P^2, 8] product per keypoint.
    Returns [B, K, 128] float32, L2-normalized with 0.2 clipping, zero
    where not valid."""
    b, k = x.shape
    dev = x.device
    grid, wgt, w_spatial = (t.to(dev) for t in _descriptor_grid(n_samples))
    sample = _Sampler(gf, base_arr, h_arr, w_arr)
    bi = _image_rows(b, k, dev)
    xr, yr, sr, ar = _rows(x), _rows(y), _rows(sigma_oct), _rows(angle)
    lr, orr = _rows(level).long(), _rows(oct_i).long()
    am = None if affine is None else _rows(affine)
    out = torch.empty((b * k, DESC_DIM), dtype=torch.float32, device=dev)
    for c in _chunks(b * k, grid.shape[0] * N_ORI_BINS):
        ca, sa = torch.cos(ar[c]), torch.sin(ar[c])
        # full patch->image map R(angle) @ A
        full = torch.stack([torch.stack([ca, -sa], -1),
                            torch.stack([sa, ca], -1)], -2)        # [N,2,2]
        if am is not None:
            full = full @ am[c]
        bw = (magnif * sr[c])[:, None]     # bin width in octave pixels
        xs, ys = _warp(xr[c], yr[c], grid[:, 0] * bw, grid[:, 1] * bw, full)
        vx, vy = sample(bi[c], orr[c], lr[c], xs, ys)
        g1, g2 = _pull_back(vx, vy, full)
        mag = torch.sqrt(g1 * g1 + g2 * g2)
        ang = torch.atan2(g2, g1)
        obinf = torch.remainder(ang, 2 * math.pi) / (2 * math.pi) * N_ORI
        t = (mag * wgt)[..., None] * _soft_one_hot(obinf, N_ORI)  # [N,P^2,8]
        out[c] = _normalize_clip(torch.matmul(w_spatial, t).reshape(-1,
                                                                    DESC_DIM))
    return torch.where(valid[..., None], out.reshape(b, k, DESC_DIM), 0.0)


def sift_descriptors(dx, dy, x, y, sigma_oct, level, angle, valid, *,
                     n_samples: int = 16, magnif: float = 3.0, affine=None):
    """sift_descriptors_flat for one octave: dx/dy [B, L, H, W]; x/y/
    sigma_oct/angle [B, K] octave coordinates; level [B, K] int."""
    return sift_descriptors_flat(
        _interleave(dx, dy), *_one_octave(dx), torch.zeros_like(level), x, y,
        sigma_oct, level, angle, valid, n_samples=n_samples, magnif=magnif,
        affine=affine)


def root_sift(desc: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """RootSIFT: L1-normalize, sqrt, (already unit-L2 afterwards).
    Matches hnsw_sifts_retrieval/makeSIFTs.cpp:79-95."""
    l1 = torch.sum(torch.abs(desc), -1, keepdim=True)
    return torch.sqrt(desc / (l1 + eps))
