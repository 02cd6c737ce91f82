"""Top-k selection with `jax.lax.top_k`'s tie order, and shard-merge.

`jax.lax.top_k` puts the lower index first among equal values; ids only
agree with `cvt_tpu` when ties break the same way. `torch.topk` promises
no order among ties (on CUDA least of all), so of its output only the
elements strictly better than the k-th value are kept; the lowest-index
elements equal to it fill the k, and those k are ordered by (value,
index). The result equals a stable sort's first k, values and ids,
bitwise.

No input in the port holds NaN: padding is +-inf, or INT32_MAX / BIG for
int32 keys. A NaN would break the selection as it breaks the sort.
"""

from __future__ import annotations

import torch

from cvt_tpu_torch.ops.linalg import pairwise_distance

# Where the stable sort of whole rows stays. k >= N / _FULL_SORT_SHARE: the
# sort costs no more than the selection's passes over the row. Rows of at
# most _SORT_MAX_ROW elements, or calls of at most _SORT_MAX_ELEMS in all:
# torch sorts short rows in one pass, and the selection's ~20 kernel
# launches cost more. On an H100 at k = 10 (_prof_topk_torch.py's sweep):
# rows of 64-1,024, sort 0.06-0.32 ms against 0.31-0.57; [8,192, 4,096]
# 1.06-1.14 ms both; [256, 16,384] 0.37-0.39 against 0.47-0.58; the
# selection wins at [256, 65,536] (0.67-0.69 against 1.33-1.46 ms),
# [8,192, 16,384] (3.1-3.2 against 10.2-11.1) and [8,192, 65,536]
# (11.5-11.7 against 39.9-43.6).
_FULL_SORT_SHARE = 4
_SORT_MAX_ROW = 4096
_SORT_MAX_ELEMS = 1 << 22


def _select(x: torch.Tensor, k: int, largest: bool):
    """The first k of a stable sort along the last axis (descending when
    `largest`) -> (values, idx int64).

    torch.topk gives the k best values, and with them every element
    strictly better than the k-th value t; which of the elements equal to
    t it returns is not defined. Those are taken in index order instead:
    the j-th element equal to t sits where the running count of equal
    elements first reaches j (a cumsum and a binary search). The k ids are
    then ordered by (value, index) with two sorts over k."""
    n = x.shape[-1]
    if (k * _FULL_SORT_SHARE >= n or n <= _SORT_MAX_ROW
            or x.numel() <= _SORT_MAX_ELEMS):
        v, i = torch.sort(x, dim=-1, descending=largest, stable=True)
        return v[..., :k], i[..., :k]
    if k <= 0:
        return x[..., :0], torch.zeros(x.shape[:-1] + (0,), dtype=torch.int64,
                                       device=x.device)
    kth, kidx = torch.topk(x, k, dim=-1, largest=largest)   # value order
    t = kth[..., -1:]
    # the elements better than t form a prefix of topk's sorted output
    n_better = torch.sum((kth > t) if largest else (kth < t), dim=-1,
                         keepdim=True)
    tie_rank = torch.cumsum(x == t, dim=-1, dtype=torch.int32)
    j = torch.arange(1, k + 1, dtype=torch.int32, device=x.device)
    tie_idx = torch.searchsorted(                          # the j-th equal
        tie_rank, j.expand(tie_rank.shape[:-1] + (k,)).contiguous())
    slot = torch.arange(k, device=x.device)
    idx = torch.where(slot < n_better, kidx, torch.gather(
        tie_idx, -1, torch.clamp_min(slot - n_better, 0)))
    # index order, then a stable sort by value: (value, index) order
    idx = torch.sort(idx, dim=-1).values
    v, order = torch.sort(torch.gather(x, -1, idx), dim=-1,
                          descending=largest, stable=True)
    return v, torch.gather(idx, -1, order)


def top_k_smallest(x: torch.Tensor, k: int):
    """k smallest along the last axis -> (values, idx), ascending, ties
    broken toward the lower index."""
    return _select(x, k, largest=False)


def top_k_largest(x: torch.Tensor, k: int):
    """k largest along the last axis -> (values, idx), descending, ties
    broken toward the lower index."""
    return _select(x, k, largest=True)


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
