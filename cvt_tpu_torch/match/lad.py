"""Least-absolute-deviations (L1) regression via ADMM (counterpart of
`cvt_tpu.match.lad`).

Reference: vlindex `SolveLeastAbsoluteDeviations`
(optim/least_absolute_deviations.{h,cc}) — ADMM for min ||Ax - b||_1
after Boyd et al., "Distributed Optimization and Statistical Learning
via the Alternating Direction Method of Multipliers" (the reference
cites the Stanford lad.m reference implementation). A is dense and the
normal equations are prefactorized once with a dense Cholesky; each
iteration is then two matrix-vector products and two triangular solves.

`cvt_tpu` stops a `lax.while_loop` on Boyd's residual test. Here the
host reads the stop flag once every `_CHECK_EVERY` iterations; in
between, an iteration after the flag is set leaves the state as it was
(`torch.where`), so the result and `iterations` are those of a check on
every iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cvt_tpu_torch.match.solvers import _f32

_CHECK_EVERY = 16


class LADResult(NamedTuple):
    x: torch.Tensor            # [D] solution
    iterations: torch.Tensor   # scalar int32
    converged: torch.Tensor    # scalar bool


def solve_lad(A, b, x0=None, *, rho: float = 1.0, alpha: float = 1.0,
              max_iters: int = 1000, absolute_tolerance: float = 1e-4,
              relative_tolerance: float = 1e-2) -> LADResult:
    """Solve min_x ||A x - b||_1 for dense A [N, D], b [N].

    Defaults mirror LeastAbsoluteDeviationsOptions
    (least_absolute_deviations.h:42-56): rho=1, over-relaxation
    alpha in [1, 1.8], Boyd's primal/dual residual stopping rule.
    x0 optionally warm-starts the solver. Runs on A's device (numpy:
    b's when it is a tensor, else the card).
    """
    A = _f32(A, b)
    b = _f32(b, A)
    n, d = A.shape
    dev = A.device
    x = (torch.zeros((d,), dtype=torch.float32, device=dev) if x0 is None
         else _f32(x0, A))

    # Prefactorize A^T A (the reference caches a sparse Cholesky of the
    # same normal matrix). Small ridge keeps rank-deficient A solvable.
    ata = A.T @ A + 1e-8 * torch.eye(d, dtype=torch.float32, device=dev)
    lower = torch.linalg.cholesky_ex(ata)[0]

    def solve_normal(rhs):
        y = torch.linalg.solve_triangular(lower, rhs[:, None], upper=False)
        return torch.linalg.solve_triangular(lower.T, y, upper=True)[:, 0]

    def shrink(v, kappa):
        return torch.sign(v) * torch.clamp_min(torch.abs(v) - kappa, 0.0)

    sqrt_n = torch.sqrt(torch.tensor(float(n), device=dev))
    sqrt_d = torch.sqrt(torch.tensor(float(d), device=dev))
    bnorm = torch.linalg.vector_norm(b)
    z = A @ x - b
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    steps = 0
    while steps < max_iters:
        for _ in range(min(_CHECK_EVERY, max_iters - steps)):
            # x-update: argmin_x (rho/2)||Ax - b - z + u||^2
            x_new = solve_normal(A.T @ (b + z - u))
            ax = A @ x_new
            ax_hat = alpha * ax + (1.0 - alpha) * (z + b)  # over-relaxation
            z_new = shrink(ax_hat - b + u, 1.0 / rho)
            u_new = u + (ax_hat - z_new - b)
            # Boyd's stopping criterion (lad.m): primal r = Ax - z - b,
            # dual s = -rho * A^T (z - z_old)
            r_norm = torch.linalg.vector_norm(ax - z_new - b)
            s_norm = torch.linalg.vector_norm(-rho * (A.T @ (z_new - z)))
            # eps_pri uses max(||Ax||, ||z||, ||b||), as the reference
            eps_pri = (sqrt_n * absolute_tolerance
                       + relative_tolerance * torch.maximum(
                           torch.maximum(torch.linalg.vector_norm(ax),
                                         torch.linalg.vector_norm(z_new)),
                           bnorm))
            eps_dual = (sqrt_d * absolute_tolerance
                        + relative_tolerance * torch.linalg.vector_norm(
                            rho * (A.T @ u_new)))
            run = ~done                    # a stopped loop keeps its state
            x = torch.where(run, x_new, x)
            z = torch.where(run, z_new, z)
            u = torch.where(run, u_new, u)
            it = it + run.to(torch.int32)
            done = done | ((r_norm < eps_pri) & (s_norm < eps_dual))
            steps += 1
        if bool(done):
            break
    return LADResult(x=x, iterations=it, converged=done)

