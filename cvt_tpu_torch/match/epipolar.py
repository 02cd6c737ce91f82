"""Two-view epipolar estimators: fundamental (7/8-point), essential
(5-point) — counterpart of `cvt_tpu.match.epipolar`.

Reference: retrieval/vlindex/src/estimators/ — fundamental_matrix
(7/8-point, fundamental_matrix.cc), essential_matrix (Nister 5-point,
essential.cc), two_view_geometry decision logic. Here: the batched
normalized 8-point algorithm (DLT + rank-2 projection), the 7-point
minimal solver (2-dim null space + closed-form Cardano cubic, up to 3
solutions), the Stewenius/Nister 5-point essential minimal solver, and
essential-from-fundamental with known intrinsics, plus Sampson error
scoring — all batched so RANSAC evaluates S hypotheses in one SVD batch.

The 5-point solver keeps `cvt_tpu`'s algorithm: the 10x10 action
matrix's eigenvalues come from fixed-iteration Aberth–Ehrlich on
p(z) = det(zI - A), with the Newton ratio p/p' evaluated through the
trace identity p'/p = tr((zI - A)^{-1}) via batched split-complex
linear solves (`torch.linalg.solve_ex`: a singular block gives a
non-finite candidate that the finiteness gates drop, never an error or
a host read); eigenvectors from delta-shifted fixed-shift inverse
iteration. Its loops run a fixed number of steps (Aberth 48, inverse
iteration 10, Durand–Kerner 80).

RANSAC draws its samples as Gumbel noise from a `torch.Generator` on the
generator's own device, moved to the points' device, so the same seed
draws the same samples on the CPU and the card; the draws cannot equal
`jax.random`'s bits. Sampling is kept apart from the fit-and-score core
(`_fundamental_core`, `_essential_core`), which takes the picks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from cvt_tpu_torch.match.ransac import _gumbel, _prepare
from cvt_tpu_torch.match.solvers import _f32, _hartley_normalize
from cvt_tpu_torch.ops.topk import top_k_largest


def _svd(a: torch.Tensor, full_matrices: bool = True):
    """torch.linalg.svd that, like `jnp.linalg.svd`, gives NaN factors
    for a matrix holding a non-finite value instead of raising (torch
    refuses such input). Finite batches are untouched."""
    bad = ~torch.isfinite(a).flatten(-2).all(-1)
    u, s, vt = torch.linalg.svd(
        torch.where(bad[..., None, None], 0.0, a),
        full_matrices=full_matrices)
    nan = bad[..., None, None]
    return (torch.where(nan, math.nan, u), torch.where(bad[..., None],
                                                        math.nan, s),
            torch.where(nan, math.nan, vt))


def _null_vector(a: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the least singular value of each
    [..., n, 9] design: V's last row. Tall designs (n >= 9) need only the
    thin SVD, whose V is already square."""
    return _svd(a, full_matrices=a.shape[-2] < a.shape[-1])[2][..., -1, :]


def _design(src, dst):
    """The epipolar DLT rows [u x, u y, u, v x, v y, v, x, y, 1]."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    return torch.stack([u * x, u * y, u, v * x, v * y, v, x, y,
                        torch.ones_like(x)], -1)


def _rank2(f: torch.Tensor, unit: bool = False) -> torch.Tensor:
    """Zero the least singular value of f [..., 3, 3]; with `unit` set
    the other two to 1 (the essential-matrix projection)."""
    u, s, vt = _svd(f)
    if unit:
        s = torch.ones_like(s)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)
    return torch.einsum("...ij,...j,...jk->...ik", u, s, vt)


def _unit_norm(f: torch.Tensor) -> torch.Tensor:
    return f / (torch.linalg.vector_norm(f.flatten(-2), dim=-1)[
        ..., None, None] + 1e-12)


def fit_fundamental_8pt(src, dst, weights=None) -> torch.Tensor:
    """Normalized 8-point fundamental matrix. src/dst [..., n>=8, 2].

    `weights` [..., n] (e.g. an inlier mask) scales design rows — zeroed
    rows drop out of the DLT null-space fit, giving a weighted refit
    without dynamic shapes. Returns F [..., 3, 3] with rank-2
    enforcement, dst^T F src ~ 0.
    """
    src = _f32(src)
    dst = _f32(dst, src)
    sn, t1 = _hartley_normalize(src)
    dn, t2 = _hartley_normalize(dst)
    a = _design(sn, dn)                                         # [..., n, 9]
    if weights is not None:
        a = a * _f32(weights, src)[..., None]
    f = _rank2(_null_vector(a).reshape(src.shape[:-2] + (3, 3)))
    # denormalize: F = T2^T Fn T1
    f = torch.einsum("...ji,...jk,...kl->...il", t2, f, t1)
    return _unit_norm(f)


def essential_from_fundamental(f, k1, k2) -> torch.Tensor:
    """E = K2^T F K1, with the (1,1,0) singular-value projection."""
    f = _f32(f)
    e = torch.einsum("...ji,...jk,...kl->...il", _f32(k2, f), f, _f32(k1, f))
    return _rank2(e, unit=True)


def sampson_error(f, src, dst) -> torch.Tensor:
    """First-order geometric (Sampson) distance of correspondences to the
    epipolar constraint. f [..., 3, 3]; src/dst [..., n, 2] -> [..., n].
    """
    f = _f32(f)
    src = _f32(src, f)
    dst = _f32(dst, f)
    x1 = torch.cat([src, torch.ones_like(src[..., :1])], -1)    # [..., n, 3]
    x2 = torch.cat([dst, torch.ones_like(dst[..., :1])], -1)
    fx1 = torch.einsum("...ij,...nj->...ni", f, x1)
    ftx2 = torch.einsum("...ji,...nj->...ni", f, x2)
    num = torch.sum(x2 * fx1, -1) ** 2
    den = (fx1[..., 0] ** 2 + fx1[..., 1] ** 2
           + ftx2[..., 0] ** 2 + ftx2[..., 1] ** 2)
    return num / torch.clamp_min(den, 1e-12)


def _score_and_lo(src, dst, valid, models, model_ok, threshold: float,
                  essential: bool = False):
    """Shared RANSAC tail: Sampson-score a flat model stack [S, 3, 3],
    pick the best valid model (the first of equal supports), LO-refit
    with the weighted 8-point over the winner's inliers (projected to an
    essential matrix when essential=True), and keep whichever supports
    more inliers. Returns (model [3, 3], inliers [N], n_inliers int32)."""
    s = models.shape[0]
    t2 = threshold * threshold
    err = sampson_error(models, src[None], dst[None])           # [S, N]
    inl = (err < t2) & valid[None, :]
    support = torch.sum(inl, -1)
    finite = torch.isfinite(models.reshape(s, -1)).all(-1) & model_ok
    support = torch.where(finite, support, -1)
    best = torch.argmax(support)
    # LO refit: weighted 8-point over ALL points with the winner's inlier
    # mask as row weights (zero rows drop out of the null-space fit)
    w = inl[best]
    f2 = fit_fundamental_8pt(src, dst, w.to(torch.float32))
    if essential:
        f2 = _rank2(f2, unit=True)
    inl2 = (sampson_error(f2, src, dst) < t2) & valid
    better = torch.sum(inl2) > support[best]
    model = torch.where(better, f2, models[best])
    inliers = torch.where(better, inl2, w)
    return model, inliers, torch.sum(inliers).to(torch.int32)


def _sample(gen, valid, n_hypotheses: int, mn: int) -> torch.Tensor:
    """Uniform minimal samples [S, mn] over the valid points: the mn
    largest of Gumbel noise, invalid points at -inf."""
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    logits = torch.where(valid, 0.0, -math.inf)
    g = _gumbel(gen, (n_hypotheses, valid.shape[0]), valid.device)
    return top_k_largest(g + logits[None, :], mn)[1]


_F_MIN_N = {"7pt": 7, "8pt": 8}


def _fundamental_core(src, dst, valid, picks, threshold: float,
                      method: str):
    """Fit every hypothesis of picks [S, 7|8] and score: the part of
    ransac_fundamental after sampling."""
    s = picks.shape[0]
    if method == "7pt":
        cands, ok = fit_fundamental_7pt(src[picks], dst[picks])
        models = cands.reshape(s * 3, 3, 3)
        model_ok = ok.reshape(s * 3)
    else:
        models = fit_fundamental_8pt(src[picks], dst[picks])   # [S, 3, 3]
        model_ok = torch.ones((s,), dtype=torch.bool, device=src.device)
    return _score_and_lo(src, dst, valid, models, model_ok, threshold)


def ransac_fundamental(gen, src, dst, valid=None, *,
                       threshold: float = 2.0, n_hypotheses: int = 256,
                       min_inliers: int = 12, method: str = "8pt"):
    """Batched-hypothesis RANSAC for F with Sampson scoring.

    method: "8pt" (normalized DLT hypotheses) or "7pt" (the reference's
    minimal solver, FundamentalMatrixSevenPointEstimator — each sample
    yields up to 3 model candidates, all scored). gen: a torch.Generator
    (None means seed 0). src/dst [N, 2]; returns (F [3,3], inliers [N]
    bool, n_inliers)."""
    if method not in _F_MIN_N:
        raise ValueError(f"unknown method {method!r}")
    src, dst, valid = _prepare(src, dst, valid)
    picks = _sample(gen, valid, n_hypotheses, _F_MIN_N[method])
    return _fundamental_core(src, dst, valid, picks, threshold, method)


def _essential_core(x1, x2, valid, picks, threshold: float):
    """Fit every 5-point hypothesis of picks [S, 5] and score: the part of
    ransac_essential after sampling."""
    s = picks.shape[0]
    cands, ok = fit_essential_5pt(x1[picks], x2[picks])        # [S, 10, 3, 3]
    return _score_and_lo(x1, x2, valid, cands.reshape(s * 10, 3, 3),
                         ok.reshape(s * 10), threshold, essential=True)


def ransac_essential(gen, x1, x2, valid=None, *,
                     threshold: float = 0.01, n_hypotheses: int = 64,
                     min_inliers: int = 12):
    """Batched-hypothesis RANSAC for the essential matrix using the
    5-point minimal solver (EssentialMatrixFivePointEstimator +
    RANSAC<> in the reference, essential.cc / ransac.h:184-259).

    x1/x2 [N, 2] in NORMALIZED camera coordinates (K^-1 applied);
    threshold is the Sampson distance in normalized units. Each of the
    n_hypotheses 5-point samples yields up to 10 essential candidates —
    all are scored in one batch. Returns (E [3,3], inliers [N],
    n_inliers)."""
    x1, x2, valid = _prepare(x1, x2, valid)
    picks = _sample(gen, valid, n_hypotheses, 5)
    return _essential_core(x1, x2, valid, picks, threshold)


# ---------------------------------------------------------------------------
# Minimal solvers: 7-point fundamental, 5-point essential (Stewenius/Nister)
# ---------------------------------------------------------------------------

def solve_cubic_real(c3, c2, c1, c0):
    """Real roots of c3 t^3 + c2 t^2 + c1 t + c0 (batched).

    Returns (roots [..., 3], valid [..., 3]). Falls back to the quadratic /
    linear root set when leading coefficients vanish. Trigonometric /
    Cardano method — closed-form, no iteration.
    """
    c3 = _f32(c3)
    c3, c2, c1, c0 = torch.broadcast_tensors(
        c3, _f32(c2, c3), _f32(c1, c3), _f32(c0, c3))
    eps = 1e-12
    is_cubic = torch.abs(c3) > eps * torch.clamp_min(torch.maximum(
        torch.abs(c2), torch.maximum(torch.abs(c1), torch.abs(c0))), 1.0)
    a = torch.where(is_cubic, c3, 1.0)
    b, c, d = c2 / a, c1 / a, c0 / a
    # depressed cubic t = s - b/3:  s^3 + p s + q
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    # three-real-root branch (disc <= 0): trigonometric
    pr = torch.clamp_max(p, -eps)
    mp3 = torch.sqrt(-pr / 3.0)
    arg = torch.clamp(3.0 * q / (2.0 * pr * mp3), -1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    kk = torch.tensor([0.0, 1.0, 2.0], dtype=torch.float32,
                      device=c3.device)
    roots3 = 2.0 * mp3[..., None] * torch.cos(
        theta[..., None] - 2.0 * math.pi * kk / 3.0)
    # one-real-root branch (disc > 0): Cardano
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    root1 = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    three = (disc <= 0.0)[..., None]
    roots = torch.where(three, roots3, root1[..., None].expand(roots3.shape))
    roots = roots - (b / 3.0)[..., None]
    valid = torch.where(three, True, torch.tensor(
        [True, False, False], device=c3.device))
    # quadratic fallback when c3 ~ 0
    qa = torch.where(torch.abs(c2) > eps, c2, 1.0)
    qd = c1 * c1 - 4.0 * c2 * c0
    qs = torch.sqrt(torch.clamp_min(qd, 0.0))
    lin = -c0 / torch.where(torch.abs(c1) > eps, c1, 1.0)
    quad_roots = torch.stack([(-c1 + qs) / (2.0 * qa),
                              (-c1 - qs) / (2.0 * qa), lin], -1)
    quad = (torch.abs(c2) > eps) & (qd >= 0.0)
    quad_valid = torch.stack(
        [quad, quad, (torch.abs(c2) <= eps) & (torch.abs(c1) > eps)], -1)
    roots = torch.where(is_cubic[..., None], roots, quad_roots)
    valid = torch.where(is_cubic[..., None], valid, quad_valid)
    return roots, valid


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    """Real cube root (torch has none): sign(x) |x|^(1/3)."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def fit_fundamental_7pt(src, dst):
    """7-point minimal fundamental solver (up to 3 solutions).

    Reference: retrieval/vlindex/src/estimators/fundamental_matrix.cc
    (FundamentalMatrixSevenPointEstimator). src/dst [..., 7, 2].
    Returns (F [..., 3, 3, 3], valid [..., 3]): the 2-dim DLT null space
    F(t) = F2 + t (F1 - F2) intersected with det F = 0 via the
    closed-form cubic — batched, no iteration.
    """
    src = _f32(src)
    dst = _f32(dst, src)
    sn, t1 = _hartley_normalize(src)
    dn, t2 = _hartley_normalize(dst)
    _, _, vt = _svd(_design(sn, dn), full_matrices=True)      # [..., 9, 9]
    return _fundamental_from_null(vt[..., 7:, :], t1, t2)


def _fundamental_from_null(null, t1, t2):
    """The cubic step of fit_fundamental_7pt on a basis [..., 2, 9] of the
    normalized design's null space (any orthonormal basis the SVD
    returns: the solutions do not depend on it, their rounding does) and
    the Hartley transforms t1, t2 [..., 3, 3]."""
    f1 = null[..., 0, :].reshape(null.shape[:-2] + (3, 3))
    f2 = null[..., 1, :].reshape(null.shape[:-2] + (3, 3))
    g = f1 - f2                                              # F(t) = f2 + t g
    # det(f2 + t g) = c0 + c1 t + c2 t^2 + c3 t^3 sampled at t=0,1,-1,2
    d0 = torch.linalg.det(f2)
    d1 = torch.linalg.det(f2 + g)
    dm1 = torch.linalg.det(f2 - g)
    d2 = torch.linalg.det(f2 + 2.0 * g)
    c0 = d0
    c2 = (d1 + dm1) / 2.0 - d0
    c3 = (d2 - 2.0 * d1 + d0 - 2.0 * c2) / 6.0
    c1 = d1 - d0 - c2 - c3
    roots, valid = solve_cubic_real(c3, c2, c1, c0)          # [..., 3]
    f = f2[..., None, :, :] + roots[..., :, None, None] * g[..., None, :, :]
    # denormalize each solution: F = T2^T Fn T1
    f = _unit_norm(torch.einsum("...ji,...sjk,...kl->...sil", t2, f, t1))
    valid = valid & torch.isfinite(f.flatten(-2)).all(-1)
    return f, valid


# ---- 5-point essential: precomputed monomial algebra (numpy, import-time)
_B1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]            # x, y, z, 1
_M2 = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1),
       (0, 0, 2), (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_M3 = ([(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1),
        (1, 0, 2), (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)] + _M2)
_M2_IDX = {e: i for i, e in enumerate(_M2)}
_M3_IDX = {e: i for i, e in enumerate(_M3)}


def _scatter_mats():
    add = lambda e1, e2: tuple(np.add(e1, e2))
    s11 = np.zeros((16, 10), np.float32)      # (deg<=1)x(deg<=1) -> deg<=2
    for i, ei in enumerate(_B1):
        for j, ej in enumerate(_B1):
            s11[i * 4 + j, _M2_IDX[add(ei, ej)]] = 1.0
    s21 = np.zeros((40, 20), np.float32)      # (deg<=2)x(deg<=1) -> deg<=3
    for i, ei in enumerate(_M2):
        for j, ej in enumerate(_B1):
            s21[i * 4 + j, _M3_IDX[add(ei, ej)]] = 1.0
    return s11, s21


_S11, _S21 = _scatter_mats()


def _p11(a, b, s11):
    """Multiply two degree<=1 polys over [x,y,z,1] -> degree<=2 [.., 10]."""
    return (a[..., :, None] * b[..., None, :]).flatten(-2) @ s11


def _p21(a, b, s21):
    """(degree<=2 [..,10]) * (degree<=1 [..,4]) -> degree<=3 [.., 20]."""
    return (a[..., :, None] * b[..., None, :]).flatten(-2) @ s21


def _durand_kerner(coeffs, iters: int = 80):
    """All complex roots of the monic REAL polynomial given by coeffs
    [..., n+1] (c0=1), returned as (real [..., n], imag [..., n]).

    Fixed-iteration Weierstrass/Durand-Kerner in explicit real/imag
    arithmetic, as in `cvt_tpu`."""
    n = coeffs.shape[-1] - 1
    c0 = _f32(coeffs)
    dev = c0.device
    # Fujiwara root-bound scaling: all roots satisfy
    # |lam| <= 2 max_k |c_k|^(1/k); substituting lam = s mu maps them
    # into the unit disk and keeps every coefficient |c_k / s^k| <= 1,
    # so degree-n Horner never overflows f32 (unscaled, a poly with
    # |c_n| ~ 1e4 diverges DK to inf -> NaN through the denominators).
    k_idx = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    fuji = torch.amax(torch.abs(c0[..., 1:]) ** (1.0 / k_idx), -1)
    s = torch.clamp_min(2.0 * fuji, 1.0)                      # [...]
    c = c0 / (s[..., None] ** torch.arange(n + 1, dtype=torch.float32,
                                           device=dev))
    seed = np.power(0.4 + 0.9j, np.arange(1, n + 1))
    shape = coeffs.shape[:-1] + (n,)
    wr = torch.as_tensor(seed.real, dtype=torch.float32,
                         device=dev).expand(shape)
    wi = torch.as_tensor(seed.imag, dtype=torch.float32,
                         device=dev).expand(shape)
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    for _ in range(iters):
        wr0, wi0 = wr, wi
        # Horner: p(w) with real coefficients
        pr = c[..., 0:1].expand(wr.shape)
        pi = torch.zeros_like(wi)
        for k in range(1, n + 1):
            pr, pi = (pr * wr - pi * wi + c[..., k:k + 1],
                      pr * wi + pi * wr)
        # denom_i = prod_{j != i} (w_i - w_j): unrolled complex product
        dr = wr[..., :, None] - wr[..., None, :] + eye       # [.., n, n]
        di = wi[..., :, None] - wi[..., None, :]
        ar = torch.ones_like(wr)
        ai = torch.zeros_like(wi)
        for j in range(n):
            br, bi = dr[..., j], di[..., j]
            ar, ai = ar * br - ai * bi, ar * bi + ai * br
        # w -= p(w) / denom  (complex division)
        m2 = torch.clamp_min(ar * ar + ai * ai, 1e-30)
        wr = wr - (pr * ar + pi * ai) / m2
        wi = wi - (pi * ar - pr * ai) / m2
        ok = torch.isfinite(wr) & torch.isfinite(wi)
        wr = torch.where(ok, wr, wr0)
        wi = torch.where(ok, wi, wi0)
    return wr * s[..., None], wi * s[..., None]


def _solve(a, b):
    """Batched solve that returns non-finite values for a singular block
    (LU's zero pivot) instead of raising, and reads nothing back."""
    return torch.linalg.solve_ex(a, b)[0]


def fit_essential_5pt(src, dst):
    """Nister/Stewenius 5-point essential matrix solver (up to 10 sols).

    Reference: retrieval/vlindex/src/estimators/essential.cc
    (EssentialMatrixFivePointEstimator). src/dst [..., 5, 2] in NORMALIZED
    camera coordinates (K^-1 applied). Returns (E [..., 10, 3, 3],
    valid [..., 10]) with dst^T E src = 0.

    Pipeline (no Groebner tables, no nonsymmetric eig), as `cvt_tpu`'s:
      1. 4-dim DLT null space E = x X + y Y + z Z + W (batched SVD);
      2. the 10 cubic constraints (det E = 0; 2 E E^T E - tr(E E^T) E = 0)
         assembled over a fixed 20-monomial basis by precomputed
         scatter-matmul polynomial products;
      3. a linear solve -> 10x10 action matrix for multiplication by x in
         the quotient ring;
      4. eigenvalues by Aberth–Ehrlich on det(zI - A); eigenvectors by
         inverse iteration -> (x, y, z).
    The null space's basis is any orthonormal basis the SVD returns, and
    steps 2-4 depend on it: two SVD implementations give the same
    solutions through differently conditioned action matrices.
    """
    src = _f32(src)
    dst = _f32(dst, src)
    x1, y1 = src[..., 0], src[..., 1]
    x2, y2 = dst[..., 0], dst[..., 1]
    a = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                     x1, y1, torch.ones_like(x1)], -1)       # [..., 5, 9]
    return _essential_from_basis(_svd(a, full_matrices=True)[2][..., 5:9, :])


def _essential_from_basis(basis):
    """Steps 2-4 of fit_essential_5pt on the null-space basis [..., 4, 9]
    (rows X, Y, Z, W) -> (E [..., 10, 3, 3], valid [..., 10])."""
    dev = basis.device
    batch = basis.shape[:-2]
    s11 = torch.as_tensor(_S11, device=dev)
    s21 = torch.as_tensor(_S21, device=dev)
    ex, ey, ez, ew = (basis[..., i, :].reshape(batch + (3, 3))
                      for i in range(4))
    # E entries as degree-1 polys over [x, y, z, 1]: [..., 3, 3, 4]
    ep = torch.stack([ex, ey, ez, ew], -1)

    def m2(i0, i1, j0, j1):
        return (_p11(ep[..., i0, j0, :], ep[..., i1, j1, :], s11)
                - _p11(ep[..., i0, j1, :], ep[..., i1, j0, :], s11))

    # cofactor expansion with poly products -> [..., 20]
    det3 = (_p21(m2(1, 2, 1, 2), ep[..., 0, 0, :], s21)
            - _p21(m2(1, 2, 0, 2), ep[..., 0, 1, :], s21)
            + _p21(m2(1, 2, 0, 1), ep[..., 0, 2, :], s21))
    # EEt[i,j] = sum_k E[i,k] E[j,k] : degree-2 [..., 3, 3, 10]
    eet = torch.stack([torch.stack([
        sum(_p11(ep[..., i, k, :], ep[..., j, k, :], s11) for k in range(3))
        for j in range(3)], -2) for i in range(3)], -3)
    tr = eet[..., 0, 0, :] + eet[..., 1, 1, :] + eet[..., 2, 2, :]
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    cmat = 2.0 * eet - eye3[..., None] * tr[..., None, None, :]
    # (C E)[i,j] = sum_k C[i,k] E[k,j] : degree-3 [..., 3, 3, 20]
    rows = [det3]
    for i in range(3):
        for j in range(3):
            rows.append(sum(_p21(cmat[..., i, k, :], ep[..., k, j, :], s21)
                            for k in range(3)))
    m = torch.stack(rows, -2)                                # [..., 10, 20]
    r = _solve(m[..., :, :10], m[..., :, 10:])               # [..., 10, 10]
    # action matrix for multiplication by x over basis
    # [x^2, xy, xz, y^2, yz, z^2, x, y, z, 1]: rows 0-5 are -r's
    # (x*x^2 = x^3, x*xy = x^2 y, x*xz = x^2 z, x*y^2, x*yz, x*z^2), and
    # x*x = x^2, x*y = xy, x*z = xz, x*1 = x pick basis elements
    amat = torch.zeros(batch + (10, 10), dtype=torch.float32, device=dev)
    amat[..., :6, :] = -r[..., :6, :]
    amat[..., 6, 0] = 1.0
    amat[..., 7, 1] = 1.0
    amat[..., 8, 2] = 1.0
    amat[..., 9, 6] = 1.0

    # ---- real eigenvalues of the action matrix --------------------------
    # Aberth-Ehrlich simultaneous iteration directly on p(z) = det(zI - A),
    # with the Newton ratio p/p' from the trace identity
    # p'/p = tr((z I - A)^{-1}) via batched linear solves — no polynomial
    # coefficients (an f32 charpoly cannot resolve clustered roots).
    # Complex arithmetic is split into real/imag with an augmented 20x20
    # real system. The mutual-repulsion term keeps the 10 candidates
    # distinct, so clusters resolve like they do for an exact eigensolver.
    eye10 = torch.eye(10, dtype=torch.float32, device=dev)
    rad = torch.amax(torch.sum(torch.abs(amat), -1), -1)    # [...] inf-norm
    rad = torch.clamp_min(rad, 1.0)
    # geometric radius spread: eigenvalue magnitudes can span 1e3x
    # (rad is only an upper bound), so seeds must cover small moduli too
    seed_c = (np.exp(1j * (2.0 * np.pi * np.arange(10) / 10.0 + 0.37))
              * np.geomspace(0.01, 0.9, 10))
    zr = rad[..., None] * torch.as_tensor(seed_c.real, dtype=torch.float32,
                                          device=dev)
    zi = rad[..., None] * torch.as_tensor(seed_c.imag, dtype=torch.float32,
                                          device=dev)
    rhs = torch.cat([eye10, torch.zeros_like(eye10)], 0).expand(
        zr.shape + (20, 10))
    off = ~torch.eye(10, dtype=torch.bool, device=dev)
    for _ in range(48):
        mr = zr[..., None, None] * eye10 - amat[..., None, :, :]
        mi = (zi[..., None, None] * eye10).expand(mr.shape)
        mm = torch.cat([torch.cat([mr, -mi], -1),
                        torch.cat([mi, mr], -1)], -2)        # [..,10,20,20]
        sol = _solve(mm, rhs)                                # [..,10,20,10]
        tr_r = torch.diagonal(sol[..., :10, :], dim1=-2, dim2=-1).sum(-1)
        tr_i = torch.diagonal(sol[..., 10:, :], dim1=-2, dim2=-1).sum(-1)
        den = torch.clamp_min(tr_r * tr_r + tr_i * tr_i, 1e-30)
        wr_, wi_ = tr_r / den, -tr_i / den                   # w = p/p'
        dzr = zr[..., :, None] - zr[..., None, :]
        dzi = zi[..., :, None] - zi[..., None, :]
        d2 = torch.where(off, torch.clamp_min(dzr * dzr + dzi * dzi, 1e-20),
                         1.0)
        sr = torch.sum(torch.where(off, dzr / d2, 0.0), -1)
        si = torch.sum(torch.where(off, -dzi / d2, 0.0), -1)
        dr = 1.0 - (wr_ * sr - wi_ * si)
        di = -(wr_ * si + wi_ * sr)
        dd = torch.clamp_min(dr * dr + di * di, 1e-30)
        zr_n = zr - (wr_ * dr + wi_ * di) / dd
        zi_n = zi - (wi_ * dr - wr_ * di) / dd
        ok = (torch.isfinite(zr_n) & torch.isfinite(zi_n)
              & (zr_n * zr_n + zi_n * zi_n
                 < 100.0 * rad[..., None] * rad[..., None]))
        zr = torch.where(ok, zr_n, zr)
        zi = torch.where(ok, zi_n, zi)
    lam = zr                                                 # [..., 10]

    # eigenvectors by FIXED-shift inverse iteration, shifted by a small
    # RELATIVE delta off the converged root (with the exact root the
    # system is singular to f32 working precision; updating the shift
    # per step lets two candidates of a near-pair migrate onto one root)
    v = torch.full(lam.shape + (10,), 1.0 / math.sqrt(10.0),
                   dtype=torch.float32, device=dev)
    delta = 1e-3 * (1.0 + torch.abs(lam))
    sh = amat[..., None, :, :] - (lam + delta)[..., :, None, None] * eye10
    for _ in range(10):
        v_n = _solve(sh, v[..., None])[..., 0]
        v_n = v_n / (torch.linalg.vector_norm(v_n, dim=-1, keepdim=True)
                     + 1e-20)
        bad = ~torch.isfinite(v_n).all(-1)
        v = torch.where(bad[..., None], v, v_n)
    av = torch.einsum("...ij,...sj->...si", amat, v)
    # final Rayleigh value for the residual gate (one-shot, no migration)
    lam = torch.sum(v * av, -1)
    eig_res = torch.linalg.vector_norm(av - lam[..., None] * v, dim=-1)
    # gate scales with ||A|| (the f32 eigenpair-residual floor), NOT with
    # |lam|: near-pairs (gap ~3e-2) demand residual well below the gap
    is_real = eig_res < 1e-4 * (1.0 + rad[..., None])

    # dedupe-select the 10 best distinct candidates: a candidate is a
    # duplicate if a strictly better (or equal-and-earlier) candidate
    # sits at the same eigenvalue; duplicates get a large penalty so the
    # selection keeps distinct roots first.
    close = (torch.abs(lam[..., :, None] - lam[..., None, :])
             < 1e-3 * (1.0 + torch.abs(lam[..., :, None])))
    res_i = eig_res[..., :, None]
    res_j = eig_res[..., None, :]
    idx = torch.arange(10, device=dev)
    better = (res_j < res_i) | ((res_j == res_i) & (idx[None, :]
                                                    < idx[:, None]))
    dup = torch.any(close & better, -1)                      # [..., S]
    penal = (eig_res + torch.where(dup, 1e6, 0.0)
             + torch.where(is_real, 0.0, 1e3))
    sel = top_k_largest(-penal, 10)[1]                       # [..., 10]
    lam = torch.gather(lam, -1, sel)
    is_real = torch.gather(is_real, -1, sel)
    v = torch.gather(v, -2, sel[..., None].expand(v.shape))  # [..., 10, 10]
    denom = v[..., 9]
    safe = torch.abs(denom) > 1e-8
    denom = torch.where(safe, denom, 1.0)
    xs, ys, zs = (v[..., i] / denom for i in (6, 7, 8))
    e = (xs[..., None, None] * ex[..., None, :, :]
         + ys[..., None, None] * ey[..., None, :, :]
         + zs[..., None, None] * ez[..., None, :, :]
         + ew[..., None, :, :])                              # [..., 10, 3, 3]
    e = _unit_norm(e)
    valid = is_real & safe & torch.isfinite(e.flatten(-2)).all(-1)
    return e, valid
