"""Bundle adjustment: Levenberg-Marquardt with a matrix-free normal
equation solve (counterpart of `cvt_tpu.match.bundle`).

Reference: vlindex/src/optim/bundle_adjustment.cc (Ceres solver over
reprojection residuals) and lib/PBA (CUDA parallel bundle adjustment —
ProgramCU.cu implements this normal-equation CG on the GPU). Poses are
axis-angle 6-vectors, points are [P, 3]; residuals are one masked [O, 2]
tensor over a static observation list. Each observation touches one
pose and one point, so its Jacobian is a [2, 6] and a [2, 3] block:
each LM step builds the blocks once (one vmapped forward-mode pass over
every observation), and every CG step forms J v and J^T u from them by two
gathers, two batched products and two `index_add_` — the same linear
map as `cvt_tpu`'s jvp / vjp of the whole residual, without a Jacobian
matrix. The LM loop reads nothing back to the host: a step is accepted
or rejected by `torch.where`, so all iters x cg_iters steps enqueue
without a sync.

Gauge freedom is fixed by freezing the first `n_fixed_poses` cameras.
Robust (Huber) weighting is applied by IRLS rescaling of residuals: the
gradient and the matvecs use the weighted rows, while the Marquardt
diagonal uses the unweighted ones (as `cvt_tpu`'s `gn_diag`).
`index_add_` adds in atomic order on the card, so the card agrees with
the CPU to a tolerance, not bitwise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-12


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3].

    Uses sin(t)/t and (1-cos t)/t^2 forms on the UNNORMALIZED cross
    matrix so the map is smooth (and differentiable) at rvec = 0 —
    plain normalize-then-Rodrigues has a NaN derivative at the identity,
    which poisons BA problems whose first camera is at the origin.
    """
    sq = torch.sum(rvec * rvec, -1, keepdim=True)
    small = sq < 1e-8
    # safe-where: the untaken branch must still have finite derivatives,
    # so divide by a clamped sq and Taylor-expand the small branch
    sq_safe = torch.where(small, 1.0, sq)
    theta = torch.sqrt(sq_safe)
    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zero = torch.zeros_like(x)
    kmat = torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1)], -2)        # [t]_x, unnormalized
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(
        kmat.shape)
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - sq / 24.0,
                    (1.0 - torch.cos(theta)) / sq_safe)
    kk = torch.sum(kmat[..., :, :, None] * kmat[..., None, :, :], -2)
    return eye + a[..., None] * kmat + b[..., None] * kk


def rotation_to_rvec(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.arccos(cos_t)
    axis = torch.stack([r[..., 2, 1] - r[..., 1, 2],
                        r[..., 0, 2] - r[..., 2, 0],
                        r[..., 1, 0] - r[..., 0, 1]], -1)
    axis = axis / torch.clamp_min(
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True), _EPS)
    return axis * theta[..., None]


class BAProblem(NamedTuple):
    """Static-shape bundle adjustment problem (tensors on one device).

    poses   [C, 6]  : (rvec, tvec) world->camera
    points  [P, 3]  : 3D points
    cam_idx [O]     : observation -> camera
    pt_idx  [O]     : observation -> point
    uv      [O, 2]  : observed NORMALIZED image coords
    mask    [O]     : 1.0 for real observations, 0.0 for padding
    """
    poses: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    mask: torch.Tensor


def _matvec3(m, v):
    """[..., 3, 3] @ [..., 3] by products and sums (no TF32 path)."""
    return torch.sum(m * v[..., None, :], -1)


def _obs_res(pose6, pt3, uv, m):
    """Masked, unweighted residual of each observation [O, 2]."""
    cam = _matvec3(rodrigues(pose6[..., :3]), pt3) + pose6[..., 3:]
    z = torch.where(torch.abs(cam[..., 2:3]) < _EPS, _EPS, cam[..., 2:3])
    return (cam[..., :2] / z - uv) * m[..., None]


def _huber_weight(r, huber_delta):
    """IRLS sqrt-weight [O, 1]: sqrt(huber'(|r|)/|r|), held constant."""
    nrm = torch.clamp_min(torch.linalg.vector_norm(r, dim=-1, keepdim=True),
                          _EPS)
    return torch.sqrt(torch.clamp(huber_delta / nrm, max=1.0))


def _residuals(poses, points, cam_idx, pt_idx, uv, mask, huber_delta):
    r = _obs_res(poses[cam_idx], points[pt_idx], uv, mask)
    if huber_delta is not None:
        r = r * _huber_weight(r, huber_delta)
    return r


def _jacobian_blocks(poses, points, cam_idx, pt_idx, uv, mask):
    """Residuals [O, 2] and their Jacobian blocks [O, 2, 6], [O, 2, 3]
    at (poses, points): nine forward-mode columns in one vmapped jvp
    (`jax.vmap(jax.jacfwd(...))`'s arithmetic), each tangent a unit
    vector on every observation at once (the residual is per
    observation)."""
    pose_o, pt_o = poses[cam_idx], points[pt_idx]

    def f(p6, x3):
        return _obs_res(p6, x3, uv, mask)

    o = pose_o.shape[0]
    eye9 = torch.eye(9, dtype=poses.dtype, device=poses.device)
    tangents = eye9[:, None, :].expand(9, o, 9)
    r, cols = torch.func.vmap(
        lambda t: torch.func.jvp(f, (pose_o, pt_o), (t[..., :6],
                                                    t[..., 6:])))(tangents)
    cols = cols.permute(1, 2, 0)                          # [O, 2, 9]
    return r[0], cols[..., :6], cols[..., 6:]


def bundle_adjust(problem: BAProblem, *, iters: int = 20,
                  cg_iters: int = 30, n_fixed_poses: int = 1,
                  huber_delta: float | None = None,
                  init_lambda: float = 1e-3):
    """Run LM; returns (poses [C,6], points [P,3], final_cost scalar).

    Each LM iteration: solve (J^T J + lam*diag) d = -J^T r by
    Jacobi-preconditioned CG, accept the step iff the true cost
    decreases (lam /= 3 on accept, *= 9 on reject, clamped to
    [1e-9, 1e6]) — a fixed-iteration, branch-free restatement of
    Ceres/PBA's trust-region loop. Runs on the problem's device.
    """
    dev = problem.poses.device
    cam_idx = problem.cam_idx.to(dev, torch.int64)
    pt_idx = problem.pt_idx.to(dev, torch.int64)
    uv = problem.uv.to(dev, torch.float32)
    mask = problem.mask.to(dev, torch.float32)
    poses = problem.poses.to(dev, torch.float32)
    points = problem.points.to(dev, torch.float32)
    n_c, n_p = poses.shape[0], points.shape[0]
    pose_free = (torch.arange(n_c, device=dev) >= n_fixed_poses).to(
        torch.float32)[:, None]

    def cost_of(ps, xs):
        r = _residuals(ps, xs, cam_idx, pt_idx, uv, mask, huber_delta)
        return 0.5 * torch.sum(r * r)

    def mask_update(dp):
        # where (not multiply) so NaN/inf in frozen entries is killed
        return torch.where(pose_free > 0, dp, 0.0)

    def jt(jc, jp, u):
        """J^T u for u [O, 2] -> ([C, 6], [P, 3])."""
        gc = torch.zeros((n_c, 6), dtype=torch.float32, device=dev)
        gp = torch.zeros((n_p, 3), dtype=torch.float32, device=dev)
        gc.index_add_(0, cam_idx, torch.sum(jc * u[..., None], 1))
        gp.index_add_(0, pt_idx, torch.sum(jp * u[..., None], 1))
        return gc, gp

    def jvec(jc, jp, vc, vp):
        """J v for v = ([C, 6], [P, 3]) -> [O, 2]."""
        return (torch.sum(jc * vc[cam_idx][:, None, :], -1)
                + torch.sum(jp * vp[pt_idx][:, None, :], -1))

    def dot(a, b):
        return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])

    lam = torch.tensor(init_lambda, dtype=torch.float32, device=dev)
    cost = cost_of(poses, points)
    for _ in range(iters):
        r, jc, jp = _jacobian_blocks(poses, points, cam_idx, pt_idx, uv,
                                     mask)
        # the Marquardt diagonal from the unweighted blocks
        dc = torch.zeros((n_c, 6), dtype=torch.float32, device=dev)
        dp = torch.zeros((n_p, 3), dtype=torch.float32, device=dev)
        dc.index_add_(0, cam_idx, torch.sum(jc * jc, 1))
        dp.index_add_(0, pt_idx, torch.sum(jp * jp, 1))
        diag = (torch.clamp_min(dc, 1e-6) * pose_free + (1.0 - pose_free),
                torch.clamp_min(dp, 1e-6))
        if huber_delta is not None:
            w = _huber_weight(r, huber_delta)             # [O, 1]
            r = r * w
            jc = jc * w[..., None]
            jp = jp * w[..., None]
        gc, gp = jt(jc, jp, r)
        rhs = (-mask_update(gc), -gp)

        # Jacobi-preconditioned CG on the damped normal equations
        precon = tuple(1.0 / (dg * (1.0 + lam) + 1e-8) for dg in diag)
        x = (torch.zeros_like(rhs[0]), torch.zeros_like(rhs[1]))
        res = rhs
        z = (precon[0] * res[0], precon[1] * res[1])
        p = z
        rz = dot(res, z)
        for _ in range(cg_iters):
            jtc, jtp = jt(jc, jp, jvec(jc, jp, p[0], p[1]))
            ap = (mask_update(jtc) + lam * diag[0] * p[0],
                  jtp + lam * diag[1] * p[1])
            alpha = rz / torch.clamp_min(dot(p, ap), _EPS)
            x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
            res = (res[0] - alpha * ap[0], res[1] - alpha * ap[1])
            z = (precon[0] * res[0], precon[1] * res[1])
            rz_new = dot(res, z)
            beta = rz_new / torch.clamp_min(rz, _EPS)
            p = (z[0] + beta * p[0], z[1] + beta * p[1])
            rz = rz_new

        new_poses = poses + mask_update(x[0])
        new_points = points + x[1]
        new_cost = cost_of(new_poses, new_points)
        accept = new_cost < cost
        poses = torch.where(accept, new_poses, poses)
        points = torch.where(accept, new_points, points)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.clamp(torch.where(accept, lam / 3.0, lam * 9.0),
                          1e-9, 1e6)
    return poses, points, cost
