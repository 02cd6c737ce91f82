"""Top-k selection with `jax.lax.top_k`'s tie order, and shard-merge.

`jax.lax.top_k` puts the lower index first among equal values; ids only
agree with `cvt_tpu` when ties break the same way. `torch.topk` promises
no order among ties (on CUDA least of all), so every selection here is a
stable sort followed by a slice of the first k.
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.ops.linalg import pairwise_distance


def top_k_smallest(x: torch.Tensor, k: int):
    """k smallest along the last axis -> (values, idx), ascending, ties
    broken toward the lower index."""
    v, i = torch.sort(x, dim=-1, stable=True)
    return v[..., :k], i[..., :k]


def top_k_largest(x: torch.Tensor, k: int):
    """k largest along the last axis -> (values, idx), descending, ties
    broken toward the lower index."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def merge_topk(dists: torch.Tensor, idx: torch.Tensor, k: int, *,
               largest: bool = False):
    """Re-select the best k of concatenated candidate lists.

    dists/idx: [..., C] candidates (per-chunk or per-shard top-k
    concatenated, `idx` holding global ids) -> ([..., k], [..., k])."""
    sel = top_k_largest if largest else top_k_smallest
    v, j = sel(dists, k)
    return v, torch.gather(idx, -1, j)


def chunked_topk_scan(q: torch.Tensor, db: torch.Tensor, k: int,
                      metric: str = "l2", chunk: int = 65536):
    """Exact top-k over a large database without a [B, N] intermediate:
    one matrix product + local top-k per `chunk` rows, merged as it goes.

    Returns (dists [B, k], idx [B, k] int32); for metric='ip' dists are
    negative inner products (smaller = closer)."""
    n = db.shape[0]
    b = q.shape[0]
    best_d = torch.full((b, k), float("inf"), dtype=torch.float32,
                        device=q.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=q.device)
    for base in range(0, n, chunk):
        part = db[base:base + chunk]
        d = pairwise_distance(q, part, metric)                   # [B, T]
        if part.shape[0] < chunk:
            # a ragged last chunk scores +inf past its end, like the
            # zero padding of the reference's fixed-shape scan
            d = torch.nn.functional.pad(d, (0, chunk - part.shape[0]),
                                        value=float("inf"))
        v, j = top_k_smallest(d, min(k, chunk))
        ids = (j + base).to(torch.int32)
        best_d, best_i = merge_topk(torch.cat([best_d, v], -1),
                                    torch.cat([best_i, ids], -1), k)
    return best_d, best_i
