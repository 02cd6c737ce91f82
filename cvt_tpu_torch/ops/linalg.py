"""Normalization and pairwise-distance primitives.

Counterpart of `cvt_tpu.ops.linalg`: the whole distance scan is one
matrix product `[B, D] x [D, N]` via the `||q||^2 - 2<q, x> + ||x||^2`
expansion. float32 products run at full precision only while TF32 is off
(`torch.backends.cuda.matmul.allow_tf32`, PyTorch's default).
"""

from __future__ import annotations

import torch

EPS = 1e-12  # matches cvt math_util.h:21 epsilon guard


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = EPS) -> torch.Tensor:
    """L2-normalize along `dim` with an epsilon guard:
    x / sqrt(sum(x^2) + eps)."""
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x * torch.rsqrt(sq + eps)


def pairwise_ip(q: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """Inner products between all query/database pairs.
    q: [B, D], db: [N, D] -> [B, N]."""
    return q @ db.T


def pairwise_l2sq(q: torch.Tensor, db: torch.Tensor, *,
                  db_sqnorm: torch.Tensor | None = None) -> torch.Tensor:
    """Squared L2 distances [B, N] via the matmul expansion, clamped at 0
    (the expansion can go slightly negative in float32).
    `db_sqnorm` ([N]) may be precomputed once per database."""
    qn = torch.sum(q * q, dim=-1, keepdim=True)                  # [B, 1]
    if db_sqnorm is None:
        db_sqnorm = torch.sum(db * db, dim=-1)                   # [N]
    d = qn - 2.0 * (q @ db.T) + db_sqnorm[None, :]
    return torch.clamp_min(d, 0.0)


def pairwise_distance(q: torch.Tensor, db: torch.Tensor, metric: str = "l2",
                      **kw) -> torch.Tensor:
    """'l2' -> squared L2 (smaller=closer); 'ip' -> negative inner product
    (smaller=closer)."""
    if metric == "l2":
        return pairwise_l2sq(q, db, **kw)
    if metric == "ip":
        return -pairwise_ip(q, db)
    raise ValueError(f"unknown metric: {metric!r}")
