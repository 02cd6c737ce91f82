"""Batched Lloyd's k-means (counterpart of `cvt_tpu.ops.kmeans`).

Every Lloyd iteration is two matrix products:
  assign:  argmin_k ||x - c_k||^2 via the  x.c  expansion      [N,D]x[D,K]
  update:  new_c = onehot(assign)^T @ x / counts               [K,N]x[N,D]
An empty centroid is re-seeded from the point currently farthest from its
assigned centroid (train_PQ_codebook.cpp:173-179).

`cvt_tpu` trains the M subspace codebooks of a product quantizer by
`jax.vmap` over this routine. Here the functions take optional leading
batch dimensions instead: x [..., N, D] with centroids [..., K, D].

Random draws take an explicit CPU `torch.Generator` where `cvt_tpu` takes
a `jax.random` key; the two give different numbers from the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.utils.device import resolve_device


class KMeansResult(NamedTuple):
    centroids: torch.Tensor    # [K, D]
    assignments: torch.Tensor  # [N] int32
    objective: torch.Tensor    # scalar: mean squared distance


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor,
                  chunk: int | None = None):
    """Nearest-centroid assignment. x: [..., N, D], centroids: [..., K, D].

    Returns (assign [..., N] int32, dist [..., N] f32 squared L2 to the
    winner, clamped at 0). Ties go to the lower centroid index, as
    `jnp.argmin` does. `chunk` bounds the [chunk, K] intermediate."""
    c_sq = torch.sum(centroids * centroids, dim=-1)              # [..., K]

    def one(xc):
        d = (torch.sum(xc * xc, dim=-1, keepdim=True)
             - 2.0 * (xc @ centroids.mT) + c_sq[..., None, :])
        a = torch.argmin(d, dim=-1)
        best = torch.gather(d, -1, a[..., None])[..., 0]
        return a.to(torch.int32), torch.clamp_min(best, 0.0)

    n = x.shape[-2]
    if chunk is None or n <= chunk:
        return one(x)
    parts = [one(x[..., s:s + chunk, :]) for s in range(0, n, chunk)]
    return (torch.cat([a for a, _ in parts], -1),
            torch.cat([d for _, d in parts], -1))


def _update(x: torch.Tensor, assign: torch.Tensor, k: int):
    """Centroid update via a one-hot matrix product. Returns (sums
    [..., K, D], counts [..., K])."""
    onehot = torch.nn.functional.one_hot(assign.long(), k).to(x.dtype)
    sums = onehot.mT @ x
    counts = torch.sum(onehot, dim=-2)
    return sums, counts


def _repair_empty(centroids: torch.Tensor, counts: torch.Tensor,
                  x: torch.Tensor, far_dist: torch.Tensor) -> torch.Tensor:
    """Re-seed empty centroids from the points farthest from their
    centroid: the j-th empty cluster takes the j-th farthest point."""
    k = centroids.shape[-2]
    empty = counts < 0.5                                         # [..., K]
    order = torch.cumsum(empty.to(torch.int64), dim=-1) - 1
    _, far_idx = top_k_largest(far_dist, k)                      # [..., K]
    donor_idx = torch.gather(far_idx, -1, order.clamp(0, k - 1))
    donors = torch.gather(
        x, -2, donor_idx[..., None].expand(*donor_idx.shape, x.shape[-1]))
    return torch.where(empty[..., None], donors, centroids)


def _lloyd(x: torch.Tensor, init_centroids: torch.Tensor, k: int,
           iters: int, chunk: int | None):
    """`iters` Lloyd steps from `init_centroids`, then a final assignment.
    Returns (centroids, assign, mean squared distance)."""
    c = init_centroids
    for _ in range(iters):
        assign, dist = kmeans_assign(x, c, chunk=chunk)
        sums, counts = _update(x, assign, k)
        new_c = sums / torch.clamp_min(counts, 1.0)[..., None]
        c = _repair_empty(new_c, counts, x, dist)
    assign, dist = kmeans_assign(x, c, chunk=chunk)
    return c, assign, torch.mean(dist, dim=-1)


def _init_random(gen: torch.Generator, x: torch.Tensor,
                 k: int) -> torch.Tensor:
    """k distinct points of x [N, D], drawn with the CPU generator `gen`."""
    idx = torch.randperm(x.shape[0], generator=gen)[:k]
    return x[idx.to(x.device)]


def _init_kmeanspp(gen: torch.Generator, x: torch.Tensor,
                   k: int) -> torch.Tensor:
    """k-means++ seeding (sequential over k; use for small k)."""
    n = x.shape[0]
    first = x[int(torch.randint(0, n, (), generator=gen))]
    cents = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    cents[0] = first
    d2 = torch.sum((x - first[None, :]) ** 2, dim=-1)
    for i in range(1, k):
        p = (d2 / torch.clamp_min(torch.sum(d2), 1e-30)).cpu()
        nxt = x[int(torch.multinomial(p, 1, generator=gen))]
        cents[i] = nxt
        d2 = torch.minimum(d2, torch.sum((x - nxt[None, :]) ** 2, dim=-1))
    return cents


def kmeans(gen: torch.Generator, x, k: int, *, iters: int = 25,
           init: str = "random", chunk: int | None = 262144,
           device=None) -> KMeansResult:
    """Full k-means: seed + `iters` Lloyd steps + final assignment.

    x: [N, D] float (array or tensor). Deterministic given `gen`, a CPU
    `torch.Generator`. `device` defaults to x's own for a tensor, else
    the card (`resolve_device`)."""
    x = torch.as_tensor(x, dtype=torch.float32,
                        device=resolve_device(device, like=x))
    if init == "random":
        c0 = _init_random(gen, x, k)
    elif init == "kmeans++":
        c0 = _init_kmeanspp(gen, x, k)
    else:
        raise ValueError(f"unknown init: {init!r}")
    c, assign, obj = _lloyd(x, c0, k, iters, chunk)
    return KMeansResult(c, assign, obj)
