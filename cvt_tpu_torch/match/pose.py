"""Absolute / relative pose estimation, fully batched (counterpart of
`cvt_tpu.match.pose`).

Reference: vlindex/src/estimators/ — absolute_pose.{h,cc} (P3PEstimator,
EPNPEstimator), essential_matrix decomposition + chirality
(PoseFromEssentialMatrix in base/pose.cc), triangulation.{h,cc},
generalized_absolute_pose.cc (GP3P), generalized_relative_pose.cc.

No Groebner/Ceres polynomial machinery:
  * P3P uses Grunert's quartic solved in CLOSED FORM (Ferrari +
    Cardano), elementwise ops only, so thousands of minimal problems
    solve as one call; each problem emits its <=4 candidate poses,
    which become extra RANSAC hypotheses.
  * PnP refit is a weighted 6+ point DLT (batched SVD) + nearest-
    rotation projection — the LO step.
  * Triangulation is the batched two-view DLT.
All rotations are [..., 3, 3], translations [..., 3], with camera
convention x_cam = R @ x_world + t.

The three RANSACs draw their samples from a `torch.Generator` (Gumbel
noise on the generator's device, `epipolar._sample`), then run a core
that takes the picks (`_pnp_core`, `_gp3p_core`, `_grp_core`); the draws
cannot equal `jax.random`'s bits, so the tests feed the cores
`cvt_tpu`'s picks.
"""

from __future__ import annotations

import math

import torch

from cvt_tpu_torch.match.epipolar import _cbrt, _sample, _svd
from cvt_tpu_torch.match.ransac import _prepare
from cvt_tpu_torch.match.solvers import _f32

_EPS = 1e-12


# --------------------------------------------------------------------------
# closed-form polynomial roots (elementwise)
# --------------------------------------------------------------------------

def _cardano_real_root(b, c, d):
    """One real root of z^3 + b z^2 + c z + d, elementwise-batched."""
    p = c - b * b / 3.0
    q = 2.0 * b ** 3 / 27.0 - b * c / 3.0 + d
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    # disc > 0: one real root via cbrt; disc <= 0: three real, trig form
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    u = _cbrt(-q / 2.0 + sq)
    v = _cbrt(-q / 2.0 - sq)
    root_pos = u + v
    # trigonometric branch (p < 0 guaranteed when disc <= 0)
    pm = torch.clamp_max(p, -_EPS)
    m = 2.0 * torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (pm * m), -1.0, 1.0)
    root_tri = m * torch.cos(torch.arccos(arg) / 3.0)
    return torch.where(disc > 0, root_pos, root_tri) - b / 3.0


def solve_quartic(c4, c3, c2, c1, c0):
    """Real roots of c4 x^4 + ... + c0 (Ferrari). Returns (roots [..., 4],
    valid [..., 4]) — invalid entries are NaN-free placeholders."""
    c4 = _f32(c4)
    c3, c2, c1, c0 = (_f32(c, c4) for c in (c3, c2, c1, c0))
    c4s = torch.where(torch.abs(c4) < _EPS, _EPS, c4)
    a, b, c, d = c3 / c4s, c2 / c4s, c1 / c4s, c0 / c4s
    # depressed quartic y^4 + p y^2 + q y + r, x = y - a/4
    p = b - 3.0 * a * a / 8.0
    q = c - a * b / 2.0 + a ** 3 / 8.0
    r = d - a * c / 4.0 + a * a * b / 16.0 - 3.0 * a ** 4 / 256.0
    # resolvent cubic: z^3 + 2p z^2 + (p^2 - 4r) z - q^2 = 0, z = m^2 >= 0
    z = _cardano_real_root(2.0 * p, p * p - 4.0 * r, -q * q)
    z = torch.clamp_min(z, 0.0)
    m = torch.sqrt(z)
    safe_m = torch.clamp_min(m, _EPS)
    # y^4+py^2+qy+r = (y^2 + m y + (p+z)/2 - q/(2m)) (y^2 - m y + ...)
    t1 = (p + z) / 2.0 - q / (2.0 * safe_m)
    t2 = (p + z) / 2.0 + q / (2.0 * safe_m)
    d1 = m * m - 4.0 * t1
    d2 = m * m - 4.0 * t2
    s1 = torch.sqrt(torch.clamp_min(d1, 0.0))
    s2 = torch.sqrt(torch.clamp_min(d2, 0.0))
    roots = torch.stack([(-m + s1) / 2.0, (-m - s1) / 2.0,
                         (m + s2) / 2.0, (m - s2) / 2.0], -1)
    valid = torch.stack([d1 >= 0, d1 >= 0, d2 >= 0, d2 >= 0], -1)
    return roots - a[..., None] / 4.0, valid


# --------------------------------------------------------------------------
# rigid alignment (Kabsch/Umeyama) and PnP
# --------------------------------------------------------------------------

def _proper(u, vt):
    """u diag(1, 1, det(u vt)) vt: the nearest rotation's sign fix."""
    det = torch.linalg.det(u @ vt)
    s = torch.ones(u.shape[:-2] + (3,), dtype=u.dtype, device=u.device)
    s[..., 2] = det
    return torch.einsum("...ij,...j,...jk->...ik", u, s, vt)


def kabsch(src, dst, weights=None):
    """Best R, t with dst ~= R @ src + t. src/dst [..., n, 3].

    Batched SVD Kabsch with reflection fix (Umeyama's det sign).
    """
    src = _f32(src)
    dst = _f32(dst, src)
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    weights = _f32(weights, src)
    w = weights[..., None] / (
        torch.sum(weights, -1)[..., None, None] + _EPS)
    mu_s = torch.sum(src * w, -2, keepdim=True)
    mu_d = torch.sum(dst * w, -2, keepdim=True)
    cov = torch.einsum("...ni,...nj->...ij", (dst - mu_d) * w, src - mu_s)
    u, _, vt = _svd(cov)
    r = _proper(u, vt)
    t = mu_d[..., 0, :] - torch.einsum("...ij,...j->...i", r,
                                       mu_s[..., 0, :])
    return r, t


def p3p(world, bearings):
    """Grunert P3P. world [..., 3, 3] points, bearings [..., 3, 3] UNIT
    rays in the camera frame. Returns (R [..., 4, 3, 3], t [..., 4, 3],
    valid [..., 4]) — up to 4 candidate poses per problem.
    """
    world = _f32(world)
    bearings = _f32(bearings, world)
    f1, f2, f3 = bearings[..., 0, :], bearings[..., 1, :], bearings[..., 2, :]
    p1, p2, p3 = world[..., 0, :], world[..., 1, :], world[..., 2, :]
    a2 = torch.sum((p2 - p3) ** 2, -1)
    b2 = torch.sum((p1 - p3) ** 2, -1)
    c2 = torch.sum((p1 - p2) ** 2, -1)
    b2s = torch.clamp_min(b2, _EPS)
    ca = torch.sum(f2 * f3, -1)   # cos(alpha): angle opposite side a
    cb = torch.sum(f1 * f3, -1)
    cg = torch.sum(f1 * f2, -1)
    A = (a2 - c2) / b2s
    B = (a2 + c2) / b2s
    C = (b2 - c2) / b2s
    D = (b2 - a2) / b2s
    c4 = (A - 1.0) ** 2 - 4.0 * (c2 / b2s) * ca * ca
    c3 = 4.0 * (A * (1.0 - A) * cb - (1.0 - B) * ca * cg
                + 2.0 * (c2 / b2s) * ca * ca * cb)
    c2_ = 2.0 * (A * A - 1.0 + 2.0 * A * A * cb * cb + 2.0 * C * ca * ca
                 - 4.0 * B * ca * cb * cg + 2.0 * D * cg * cg)
    c1 = 4.0 * (-A * (1.0 + A) * cb + 2.0 * (a2 / b2s) * cg * cg * cb
                - (1.0 - B) * ca * cg)
    c0 = (1.0 + A) ** 2 - 4.0 * (a2 / b2s) * cg * cg
    v, valid = solve_quartic(c4, c3, c2_, c1, c0)         # [..., 4]
    valid = valid & (v > _EPS)

    Ae = A[..., None]
    cae, cbe, cge = ca[..., None], cb[..., None], cg[..., None]
    den_u = 2.0 * (cge - v * cae)
    u = ((-1.0 + Ae) * v * v - 2.0 * Ae * cbe * v + 1.0 + Ae) / torch.where(
        torch.abs(den_u) < _EPS, _EPS, den_u)
    valid = valid & (u > _EPS)
    s1sq = b2s[..., None] / torch.clamp_min(
        1.0 + v * v - 2.0 * v * cbe, _EPS)
    s1 = torch.sqrt(s1sq)
    s2 = u * s1
    s3 = v * s1
    # camera-frame points [..., 4, 3, 3]
    cam = torch.stack([s1[..., None] * f1[..., None, :],
                       s2[..., None] * f2[..., None, :],
                       s3[..., None] * f3[..., None, :]], -2)
    wrld = world[..., None, :, :].expand(cam.shape)
    r, t = kabsch(wrld, cam)                               # world -> cam
    return r, t, valid


def fit_pnp_dlt(world, image, weights=None):
    """Weighted 6+ point DLT projection fit, decomposed to (R, t).

    world [..., n, 3], image [..., n, 2] NORMALIZED camera coords.
    The DLT minimizes algebraic error; R is recovered as the nearest
    rotation (SVD) to the left 3x3 block — the LO-refit counterpart of
    COLMAP's EPNPEstimator.
    """
    world = _f32(world)
    image = _f32(image, world)
    ones = torch.ones(world.shape[:-1] + (1,), dtype=world.dtype,
                      device=world.device)
    xw = torch.cat([world, ones], -1)                      # [..., n, 4]
    x, y = image[..., 0:1], image[..., 1:2]
    zero = torch.zeros_like(xw)
    r1 = torch.cat([xw, zero, -x * xw], -1)                # [..., n, 12]
    r2 = torch.cat([zero, xw, -y * xw], -1)
    a = torch.cat([r1, r2], -2)                            # [..., 2n, 12]
    if weights is not None:
        weights = _f32(weights, world)
        a = a * torch.cat([weights, weights], -1)[..., None]
    vt = _svd(a, full_matrices=False)[2]
    p = vt[..., -1, :].reshape(world.shape[:-2] + (3, 4))
    # sign: points should be in front (positive depth for the centroid)
    ctr = torch.cat([torch.mean(world, -2), ones[..., 0, :]], -1)
    depth = torch.sum(p[..., 2, :] * ctr, -1)
    p = p * torch.where(depth < 0, -1.0, 1.0)[..., None, None]
    m = p[..., :3]
    scale = _cbrt(torch.abs(torch.linalg.det(m)) + _EPS)
    m = m / scale[..., None, None]
    u, _, vtm = _svd(m)
    r = _proper(u, vtm)
    t = p[..., 3] / scale[..., None]
    return r, t


def project(r, t, world):
    """x_cam = R X + t -> normalized image coords. world [..., n, 3]."""
    cam = torch.einsum("...ij,...nj->...ni", r, world) + t[..., None, :]
    return cam[..., :2] / torch.where(
        torch.abs(cam[..., 2:3]) < _EPS, _EPS, cam[..., 2:3]), cam[..., 2]


def _pnp_core(world, image, valid, picks, threshold: float):
    """P3P on every sample of picks [S, 3], score all <=4S candidates, LO
    refit on the winner: the part of ransac_pnp after sampling."""
    n = world.shape[0]
    w3 = world[picks]                                      # [S, 3, 3]
    i3 = image[picks]                                      # [S, 3, 2]
    bear = torch.cat([i3, torch.ones_like(i3[..., :1])], -1)
    bear = bear / torch.linalg.vector_norm(bear, dim=-1, keepdim=True)
    r, t, ok = p3p(w3, bear)                               # [S, 4, ...]
    rs = r.reshape(-1, 3, 3)
    ts = t.reshape(-1, 3)
    oks = ok.reshape(-1)
    proj, depth = project(rs, ts, world.expand(rs.shape[0], n, 3))
    res2 = torch.sum((proj - image[None]) ** 2, -1)
    inl = (res2 < threshold * threshold) & (depth > 0) & valid[None, :]
    support = torch.where(oks, torch.sum(inl, -1), -1)
    best = torch.argmax(support)
    best_inl = inl[best]
    # LO: weighted DLT on the winning inlier set, kept if support does not
    # shrink (>=, as cvt_tpu; the epipolar RANSACs need strictly more)
    r2_, t2_ = fit_pnp_dlt(world, image, best_inl.to(torch.float32))
    proj2, depth2 = project(r2_, t2_, world)
    rr2 = torch.sum((proj2 - image) ** 2, -1)
    inl2 = (rr2 < threshold * threshold) & (depth2 > 0) & valid
    better = torch.sum(inl2) >= torch.sum(best_inl)
    r_out = torch.where(better, r2_, rs[best])
    t_out = torch.where(better, t2_, ts[best])
    inliers = torch.where(better, inl2, best_inl)
    return r_out, t_out, inliers, torch.sum(inliers).to(torch.int32)


def ransac_pnp(gen, world, image, valid=None, *, threshold: float = 0.01,
               n_hypotheses: int = 64, min_inliers: int = 6):
    """Absolute-pose RANSAC: P3P minimal solves, all <=4S candidate poses
    scored in parallel, then a weighted-DLT LO refit on the winner.

    gen: a torch.Generator (None means seed 0). world [N, 3]; image
    [N, 2] normalized coords; threshold in normalized units
    (~pixels/focal). min_inliers is accepted and unused, as in
    `cvt_tpu`. Returns (R, t, inliers [N] bool, n_inliers).
    """
    world, image, valid = _prepare(world, image, valid)
    picks = _sample(gen, valid, n_hypotheses, 3)
    return _pnp_core(world, image, valid, picks, threshold)


def triangulate_dlt(r1, t1, r2, t2, x1, x2) -> torch.Tensor:
    """Two-view linear triangulation. (r_i, t_i) world->cam poses;
    x1/x2 [..., n, 2] normalized coords. Returns world points [..., n, 3].
    """
    p1 = torch.cat([r1, t1[..., :, None]], -1)               # [..., 3, 4]
    p2 = torch.cat([r2, t2[..., :, None]], -1)

    def rows(p, x):
        # x [..., n, 2]; p [..., 3, 4] -> [..., n, 2, 4]
        pe = p[..., None, :, :]
        return torch.stack([x[..., 0:1] * pe[..., 2, :] - pe[..., 0, :],
                            x[..., 1:2] * pe[..., 2, :] - pe[..., 1, :]],
                           -2)

    a = torch.cat([rows(p1, x1), rows(p2, x2)], -2)          # [..., n, 4, 4]
    xh = _svd(a)[2][..., -1, :]
    w = xh[..., 3:]
    return xh[..., :3] / torch.where(torch.abs(w) < _EPS, _EPS, w)


def decompose_essential(e):
    """E -> 4 candidate (R, t): (R1,t), (R1,-t), (R2,t), (R2,-t).
    Returns (r [..., 4, 3, 3], t [..., 4, 3])."""
    e = _f32(e)
    u, _, vt = _svd(e)
    # enforce proper rotations
    u = u * torch.linalg.det(u)[..., None, None]
    vt = vt * torch.linalg.det(vt)[..., None, None]
    w = torch.tensor([[0., -1., 0.], [1., 0., 0.], [0., 0., 1.]],
                     dtype=e.dtype, device=e.device)
    r1 = torch.einsum("...ij,jk,...kl->...il", u, w, vt)
    r2 = torch.einsum("...ij,jk,...kl->...il", u, w.T, vt)
    t = u[..., :, 2]
    return (torch.stack([r1, r1, r2, r2], -3),
            torch.stack([t, -t, t, -t], -2))


def pose_from_essential(e, x1, x2, valid=None):
    """Pick the (R, t) among the 4 decompositions with the most points
    passing the chirality test (positive depth in both views; the first
    of equal counts).

    x1/x2 [n, 2] normalized coords. Returns (R, t, n_cheiral).
    Reference semantics: base/pose.cc PoseFromEssentialMatrix.
    """
    e = _f32(e)
    x1 = _f32(x1, e)
    x2 = _f32(x2, e)
    if valid is None:
        valid = torch.ones(x1.shape[:-1], dtype=torch.bool, device=e.device)
    r4, t4 = decompose_essential(e)                        # [4,3,3], [4,3]
    eye = torch.eye(3, dtype=e.dtype, device=e.device).expand(r4.shape)
    pts = triangulate_dlt(eye, torch.zeros_like(t4), r4, t4,
                          x1.expand((4,) + x1.shape),
                          x2.expand((4,) + x2.shape))
    z1 = pts[..., 2]
    cam2 = torch.einsum("...ij,...nj->...ni", r4, pts) + t4[..., None, :]
    good = (z1 > 0) & (cam2[..., 2] > 0) & valid[None, :]
    counts = torch.sum(good, -1)
    best = torch.argmax(counts)
    return r4[best], t4[best], counts[best]


# ---------------------------------------------------------------------------
# GP3P: generalized absolute pose (multi-camera rig) from 3 ray-point
# correspondences. Reference: vlindex/src/estimators/
# generalized_absolute_pose.cc (GP3PEstimator: depths along three rays
# with known origins such that pairwise point distances are preserved,
# then rig-from-world alignment).
#
# Instead of the reference's Sylvester-resultant octic + companion
# eigenvalues, the depth lambda_0 of ray 0 is found by a batched branch
# scan — lambda_1(lambda_0) and lambda_2(lambda_0) are closed-form
# quadratic roots (2 branches each), the remaining constraint g(lambda_0)
# is evaluated on a tan-warped depth grid for all 4 branch combinations
# at once, and the first sign change is refined by fixed-iteration
# bisection. Samples and branches are leading dimensions of one batch.
# ---------------------------------------------------------------------------


def _row(v, j: int, nd: int):
    """Row j of v [B..., 3, 3] shaped to broadcast against a tensor of
    nd leading dims whose first dims are B... : [B..., 1, ..., 3]."""
    r = v[..., j, :]
    return r.reshape(r.shape[:-1] + (1,) * (nd - r.ndim + 1) + (3,))


def _gp3p_g(lam0, o, d, x, s1, s2):
    """Residual g(lambda_0) for branch signs (s1, s2) in {-1, +1}.

    o, d, x: [B..., 3, 3] ray origins, unit directions, world points;
    lam0 [B..., E...] and s1, s2 broadcast against it. Returns (g value,
    lam1, lam2, feasible) — feasible = both inner quadratics have real
    positive roots."""
    nd = lam0.ndim

    def sqd(i, j):
        v = torch.sum((x[..., i, :] - x[..., j, :]) ** 2, -1)
        return v.reshape(v.shape + (1,) * (nd - v.ndim))

    d01, d02, d12 = sqd(0, 1), sqd(0, 2), sqd(1, 2)
    p0 = _row(o, 0, nd) + lam0[..., None] * _row(d, 0, nd)

    def depth(j, dsq, sgn):
        w = p0 - _row(o, j, nd)                   # [..., 3]
        b = torch.sum(w * _row(d, j, nd), -1)
        disc = b * b - torch.sum(w * w, -1) + dsq
        ok = disc >= 0.0
        lam = b + sgn * torch.sqrt(torch.clamp_min(disc, 0.0))
        return lam, ok & (lam > 0.0)

    lam1, ok1 = depth(1, d01, s1)
    lam2, ok2 = depth(2, d02, s2)
    p1 = _row(o, 1, nd) + lam1[..., None] * _row(d, 1, nd)
    p2 = _row(o, 2, nd) + lam2[..., None] * _row(d, 2, nd)
    g = torch.sum((p1 - p2) ** 2, -1) - d12
    return g, lam1, lam2, ok1 & ok2


def gp3p(origins, directions, points, *, n_grid: int = 128,
         bisect_iters: int = 48):
    """Solve generalized P3P for minimal samples.

    origins/directions [..., 3, 3]: per-correspondence ray origin + unit
    direction in the RIG frame; points [..., 3, 3]: world points. Returns
    (r [..., 4, 3, 3], t [..., 4, 3], ok [..., 4]), one per sign branch:
    world->rig transforms p_rig = R x_world + t for every found root (ok
    masks branches with no sign change / infeasible depths).
    """
    o = _f32(origins)
    d = _f32(directions, o)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    x = _f32(points, o)
    dev = o.device
    batch = o.shape[:-2]

    # depth grid: tan warp concentrates resolution near the scene scale
    # while still covering (0, ~60 * scale)
    sides = torch.stack([torch.sum((x[..., i, :] - x[..., j, :]) ** 2, -1)
                         for i, j in ((0, 1), (0, 2), (1, 2))], -1)
    scale = (torch.sqrt(torch.amax(sides, -1))
             + torch.amax(torch.linalg.vector_norm(
                 o - o[..., 0:1, :], dim=-1), -1) + 1e-6)      # [B...]
    tt = (torch.arange(n_grid, dtype=torch.float32, device=dev) + 0.5) \
        / n_grid
    grid = scale[..., None] * torch.tan(tt * (math.pi / 2) * 0.975)
    s1 = torch.tensor([1., 1., -1., -1.], device=dev)
    s2 = torch.tensor([1., -1., 1., -1.], device=dev)

    # the grid for every branch: lam0 [B..., 4, G]
    lam_g = grid[..., None, :].expand(batch + (4, n_grid))
    g, _, _, ok = _gp3p_g(lam_g, o, d, x, s1[:, None], s2[:, None])
    g = torch.where(ok, g, math.nan)
    flip = g[..., :-1] * g[..., 1:] < 0.0                  # [B..., 4, G-1]
    has = torch.any(flip, -1)
    i = torch.argmax(flip.to(torch.uint8), -1)             # first flip
    gb = grid[..., None, :].expand(batch + (4, n_grid))
    sc = scale[..., None]
    lo = torch.where(has, torch.gather(gb, -1, i[..., None])[..., 0], sc)
    hi = torch.where(has, torch.gather(gb, -1, i[..., None] + 1)[..., 0],
                     sc * 2)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        gm = _gp3p_g(mid, o, d, x, s1, s2)[0]
        gl = _gp3p_g(lo, o, d, x, s1, s2)[0]
        same = gm * gl > 0.0
        lo, hi = torch.where(same, mid, lo), torch.where(same, hi, mid)
    lam0 = 0.5 * (lo + hi)                                 # [B..., 4]
    gv, lam1, lam2, okv = _gp3p_g(lam0, o, d, x, s1, s2)
    p_rig = torch.stack([_row(o, j, lam0.ndim) + lam[..., None]
                         * _row(d, j, lam0.ndim)
                         for j, lam in ((0, lam0), (1, lam1), (2, lam2))],
                        -2)                                # [B..., 4, 3, 3]
    r, t = kabsch(x[..., None, :, :].expand(p_rig.shape), p_rig)
    ok_all = has & okv & (torch.abs(gv) < 1e-3 * sc * sc)
    return r, t, ok_all


def _gp3p_core(o, d, x, valid, picks, threshold: float, min_inliers: int):
    """GP3P on every sample of picks [S, 3], score all 4S candidates: the
    part of ransac_gp3p after sampling."""
    r, t, ok = gp3p(o[picks], d[picks], x[picks])          # [S, 4, ...]
    r = r.reshape(-1, 3, 3)                                # [S*4, 3, 3]
    t = t.reshape(-1, 3)
    ok = ok.reshape(-1)
    # residual: 1 - cos(angle) between d_i and normalize(R x_i + t - o_i)
    px = torch.einsum("sab,nb->sna", r, x) + t[:, None, :] - o[None, :, :]
    pxn = px / torch.clamp_min(
        torch.linalg.vector_norm(px, dim=-1, keepdim=True), 1e-12)
    res = 1.0 - torch.sum(pxn * d[None, :, :], -1)         # [S*4, N]
    inl = (res < threshold) & valid[None, :]
    support = torch.where(ok, torch.sum(inl, -1), -1)
    best = torch.argmax(support)
    # no feasible hypothesis, or support below min_inliers: report ZERO
    # inliers so callers can detect failure
    good = (support[best] >= 0) & (support[best] >= min_inliers)
    inl_best = inl[best] & good
    return r[best], t[best], inl_best, torch.sum(inl_best).to(torch.int32)


def ransac_gp3p(gen, origins, directions, points, valid=None, *,
                threshold: float = 0.01, n_hypotheses: int = 128,
                min_inliers: int = 6):
    """Generalized-absolute-pose RANSAC over N ray-point matches.

    gen: a torch.Generator (None means seed 0). origins/directions
    [N, 3] rig-frame rays; points [N, 3] world. Residual: 1 - cos of the
    angle between the observed ray direction and the direction to the
    transformed point (the GP3PEstimator cosine residual). Returns (r, t,
    inliers, n_inliers); zero inliers when no hypothesis reaches
    min_inliers.
    """
    x, o, valid = _prepare(points, origins, valid)
    d = _f32(directions, x)
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    picks = _sample(gen, valid, n_hypotheses, 3)
    return _gp3p_core(o, d, x, valid, picks, threshold, min_inliers)


def similarity_transform(src, dst, weights=None):
    """3-D similarity alignment (base/similarity_transform.h — Umeyama):
    returns (scale, R [3,3], t [3]) with dst ~= scale * R src + t.
    Batched over leading axes like kabsch."""
    src = _f32(src, dst)
    dst = _f32(dst, src)
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    weights = _f32(weights, src)
    w = weights[..., None] / (
        torch.sum(weights, -1)[..., None, None] + _EPS)
    mu_s = torch.sum(src * w, -2, keepdim=True)
    mu_d = torch.sum(dst * w, -2, keepdim=True)
    r, _ = kabsch(src, dst, weights)
    s0 = src - mu_s
    var_s = torch.sum(torch.sum(s0 * s0, -1) * weights, -1) / (
        torch.sum(weights, -1) + _EPS)
    rs = torch.einsum("...ij,...nj->...ni", r, s0)
    cov = torch.sum(torch.sum(rs * (dst - mu_d), -1) * weights, -1) / (
        torch.sum(weights, -1) + _EPS)
    scale = cov / torch.clamp_min(var_s, _EPS)
    t = (mu_d[..., 0, :] - scale[..., None]
         * torch.einsum("...ij,...j->...i", r, mu_s[..., 0, :]))
    return scale, r, t


# ---------------------------------------------------------------------------
# Generalized relative pose (rig-to-rig). Reference:
# vlindex/src/estimators/generalized_relative_pose.cc (GR6P, Stewenius'
# 64-solution minimal solver via Groebner bases + eigendecomposition).
#
# Here the LINEAR 17-point formulation (the generalized epipolar
# constraint is linear in the 18 entries of (E, R)):
#     d2^T E d1 + d2^T R m1 + m2^T R d1 = 0
# with Pluecker moments m = o x d. One batched SVD of the [N, 18]
# design matrix gives (E, R) up to scale; R projects to SO(3) by SVD
# and t comes from [t]x = E R^T.
# ---------------------------------------------------------------------------


def fit_generalized_relative_pose(o1, d1, o2, d2):
    """(R, t) with rig2 = R * rig1 + t from >= 17 ray-ray matches.

    o*/d* [..., n, 3]: ray origins + unit directions in each rig frame.
    Convention: a world point X satisfies, in rig frames,
    x2 = R x1 + t; rays (o_i, d_i) pass through x_i.
    """
    o1 = _f32(o1)
    d1, o2, d2 = (_f32(v, o1) for v in (d1, o2, d2))
    m1 = torch.linalg.cross(o1, d1, dim=-1)
    m2 = torch.linalg.cross(o2, d2, dim=-1)
    # rows: kron terms for  d2^T E d1  (E entries), and
    # d2^T R m1 + m2^T R d1  (R entries)
    lead = d1.shape[:-1]
    e_block = (d2[..., :, None] * d1[..., None, :]).reshape(lead + (9,))
    r_block = (d2[..., :, None] * m1[..., None, :]
               + m2[..., :, None] * d1[..., None, :]).reshape(lead + (9,))
    a = torch.cat([e_block, r_block], -1)                  # [..., n, 18]
    sol = _svd(a, full_matrices=True)[2][..., -1, :]       # [..., 18]
    e = sol[..., :9].reshape(sol.shape[:-1] + (3, 3))
    r_raw = sol[..., 9:].reshape(sol.shape[:-1] + (3, 3))
    # project r_raw to a rotation; fix the global sign so det(+R) = +1
    u, s, vtr = _svd(r_raw)
    det = torch.linalg.det(u @ vtr)
    # r_raw = sigma * R_true: det(u vt) = sign(sigma), so R_true =
    # sign(sigma) * u vt (det +1 restored)
    sign = torch.sign(det)[..., None, None]
    r = (u * sign) @ vtr
    # common scale of the solution vector: rotations have unit singular
    # values; undo it on E before extracting t
    scale = torch.mean(s, -1)[..., None, None] * sign
    e = e / torch.clamp_min(torch.abs(scale), 1e-12) * torch.sign(scale)
    tx = e @ r.transpose(-1, -2)                           # [t]x = E R^T
    t = torch.stack([tx[..., 2, 1] - tx[..., 1, 2],
                     tx[..., 0, 2] - tx[..., 2, 0],
                     tx[..., 1, 0] - tx[..., 0, 1]], -1) * 0.5
    return r, t


def generalized_epipolar_residual(r, t, o1, d1, o2, d2):
    """|generalized epipolar constraint| per match (the GR6P residual)."""
    r = _f32(r)
    t, o1, d1, o2, d2 = (_f32(v, r) for v in (t, o1, d1, o2, d2))
    m1 = torch.linalg.cross(o1, d1, dim=-1)
    m2 = torch.linalg.cross(o2, d2, dim=-1)
    zero = torch.zeros_like(t[..., 0])
    tx = torch.stack([
        torch.stack([zero, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], zero, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], zero], -1)], -2)
    e = tx @ r
    v = (torch.einsum("...ni,...ij,...nj->...n", d2, e, d1)
         + torch.einsum("...ni,...ij,...nj->...n", d2, r, m1)
         + torch.einsum("...ni,...ij,...nj->...n", m2, r, d1))
    return torch.abs(v)


def _grp_core(o1, d1, o2, d2, valid, picks, threshold: float,
              min_inliers: int):
    """Fit every sample of picks [S, sample_size] and score: the part of
    ransac_generalized_relative_pose after sampling."""
    r, t = fit_generalized_relative_pose(o1[picks], d1[picks],
                                         o2[picks], d2[picks])
    res = generalized_epipolar_residual(
        r[:, None], t[:, None], o1[None], d1[None], o2[None], d2[None])
    inl = (res < threshold) & valid[None, :]
    support = torch.sum(inl, -1)
    best = torch.argmax(support)
    good = support[best] >= min_inliers    # failure -> zero inliers
    inl_best = inl[best] & good
    return r[best], t[best], inl_best, torch.sum(inl_best).to(torch.int32)


def ransac_generalized_relative_pose(gen, o1, d1, o2, d2, valid=None, *,
                                     threshold: float = 1e-4,
                                     n_hypotheses: int = 256,
                                     sample_size: int = 20,
                                     min_inliers: int = 20):
    """RANSAC over 17+-point generalized-relative-pose samples.

    gen: a torch.Generator (None means seed 0). Caveat (inherent to the
    linear solver): a 17+-point sample needs (1-eps)^20 clean-sample
    probability, so this tolerates only LOW outlier rates (<~15% at the
    default 256 hypotheses) — raise n_hypotheses for dirtier matches."""
    o1, d1, valid = _prepare(o1, d1, valid)
    o2, d2 = _f32(o2, o1), _f32(d2, o1)
    picks = _sample(gen, valid, n_hypotheses, sample_size)
    return _grp_core(o1, d1, o2, d2, valid, picks, threshold, min_inliers)
