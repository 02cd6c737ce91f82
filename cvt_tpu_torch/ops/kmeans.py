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

The second half holds the large-vocabulary quantizers: exact assignment
by a running minimum over word blocks (`kmeans_assign_blocked`) and the
two-level vocabulary (`hierarchical_kmeans`, `hierarchical_assign`), the
replacement for FLANN's hierarchical k-means tree
(visual_index.h:624-665). Python loops over chunks, blocks and probes
stand in for `lax.map` / `lax.scan`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cvt_tpu_torch.ops.topk import top_k_largest, top_k_smallest
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


def _blocked_argmin_chunk(xc: torch.Tensor, centroids: torch.Tensor,
                          word_block: int):
    """Exact argmin over a huge centroid set without the [T, K] distance
    matrix: one [T, word_block] block at a time with a running (best
    dist, best id). Within a block the first index of the minimum wins;
    across blocks only a strict improvement updates, so the earlier block
    wins a tie, as in `cvt_tpu`."""
    x_sq = torch.sum(xc * xc, -1, keepdim=True)                   # [T, 1]
    best_d = torch.full((xc.shape[0],), 3.4e38, dtype=torch.float32,
                        device=xc.device)
    best_w = torch.zeros((xc.shape[0],), dtype=torch.int32, device=xc.device)
    for off in range(0, centroids.shape[0], word_block):
        cb = centroids[off:off + word_block]
        d = x_sq - 2.0 * (xc @ cb.T) + torch.sum(cb * cb, -1)[None, :]
        a = torch.argmin(d, -1)
        db = torch.gather(d, -1, a[:, None])[:, 0]
        upd = db < best_d
        best_d = torch.where(upd, db, best_d)
        best_w = torch.where(upd, (a + off).to(torch.int32), best_w)
    return best_w, torch.clamp_min(best_d, 0.0)


def kmeans_assign_blocked(x, centroids, *, chunk: int = 8192,
                          word_block: int = 16384, device=None):
    """Exact nearest-centroid assignment for centroid sets too large for
    one [N, K] distance matrix (e.g. the 1,048,576-word vocabulary,
    visual_index.h:624-665 / exe/vocab_tree.cc:74-78): a running minimum
    over centroid blocks, peak memory one [chunk, word_block] block.
    `word_block` is halved until it divides K. Returns (assign [N] int32,
    squared distance [N] f32). `device` defaults to x's own for a tensor,
    else the card."""
    dev = resolve_device(device, like=x)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    centroids = torch.as_tensor(centroids, dtype=torch.float32, device=dev)
    k = centroids.shape[0]
    wb = min(word_block, k)
    while k % wb:
        wb //= 2
    parts = [_blocked_argmin_chunk(x[s:s + chunk], centroids, wb)
             for s in range(0, x.shape[0], chunk)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([d for _, d in parts]))


# Hierarchical (two-level) k-means, the replacement for FLANN's
# hierarchical k-means tree (visual_index.h:624-665, branching 256): a
# coarse level of k1 centroids, then an independent k2-means inside every
# coarse cell, k1*k2 words in all.

class HierKMeansResult(NamedTuple):
    coarse: torch.Tensor     # [K1, D]
    fine: torch.Tensor       # [K1, K2, D] per-cell codebooks
    objective: torch.Tensor  # scalar: mean squared distance (training sample)

    @property
    def n_words(self) -> int:
        return self.fine.shape[0] * self.fine.shape[1]

    def flat_words(self) -> torch.Tensor:
        """[K1*K2, D] flattened vocabulary (word id = cell*K2 + sub)."""
        k1, k2, d = self.fine.shape
        return self.fine.reshape(k1 * k2, d)


def _masked_lloyd_batch(xs: torch.Tensor, mask: torch.Tensor,
                        c0: torch.Tensor, k: int, iters: int):
    """Masked Lloyd over a batch of cells: xs [C, S, D] padded per-cell
    samples, mask [C, S] validity, c0 [C, k, D] initial centroids ->
    (centroids [C, k, D], objective [C] of the last step). Empty clusters
    are re-seeded from the cell's farthest valid point each step; a cell
    with no valid point keeps its initial centroids."""
    big = 3.4e38
    x_sq = torch.sum(xs * xs, -1, keepdim=True)                  # [C, S, 1]
    m_sum = torch.sum(mask, -1)                                  # [C]
    c, obj = c0, None
    for _ in range(iters):
        d = x_sq - 2.0 * (xs @ c.mT) + torch.sum(c * c, -1)[:, None, :]
        a = torch.argmin(d, -1)                                  # [C, S]
        best = torch.clamp_min(torch.gather(d, -1, a[..., None])[..., 0],
                               0.0)
        # one_hot(a) * mask, without the int64 one-hot
        onehot = torch.zeros_like(d).scatter_(-1, a[..., None],
                                              mask[..., None])
        sums = onehot.mT @ xs
        counts = torch.sum(onehot, -2)                           # [C, k]
        new_c = sums / torch.clamp_min(counts, 1.0)[..., None]
        far = torch.where(mask > 0.5, best, -big)
        repaired = _repair_empty(new_c, counts, xs, far)
        obj = torch.sum(best * mask, -1) / torch.clamp_min(m_sum, 1.0)
        c = torch.where((m_sum > 0.5)[:, None, None], repaired, c)
    return c, obj


def hierarchical_kmeans(gen: torch.Generator, x, k1: int = 256,
                        k2: int = 256, *, coarse_iters: int = 15,
                        fine_iters: int = 12, sample_per_cell: int = 4096,
                        cell_chunk: int = 64, chunk: int | None = 262144,
                        device=None) -> HierKMeansResult:
    """Two-level vocabulary: coarse k1-means, then k2-means per cell.

    Cells train on up to `sample_per_cell` member points (subsampled
    deterministically), `cell_chunk` cells per batch. Cells with fewer
    than k2 members fill the spare centroids with jittered copies of their
    members (harmless duplicate words). The host subsampling draws from
    numpy's `default_rng(gen.initial_seed())`, where `cvt_tpu` seeds it
    from the key's data: for a key made from seed s and a generator
    seeded with s both start from s. `device` defaults to x's own for a
    tensor, else the card."""
    x = torch.as_tensor(x, dtype=torch.float32,
                        device=resolve_device(device, like=x))
    dev = x.device
    n, d = x.shape
    res = kmeans(gen, x, k1, iters=coarse_iters, chunk=chunk)
    coarse = res.centroids
    asg = res.assignments.cpu().numpy()

    rng = np.random.default_rng(gen.initial_seed())
    order = np.argsort(asg, kind="stable")
    starts = np.searchsorted(asg[order], np.arange(k1 + 1))
    xs_np = x.cpu().numpy()
    coarse_np = coarse.cpu().numpy()

    s = max(1, min(sample_per_cell, n))
    fine = np.zeros((k1, k2, d), np.float32)
    objs = []
    for lo in range(0, k1, cell_chunk):
        hi = min(k1, lo + cell_chunk)
        c = hi - lo
        samp = np.zeros((c, s, d), np.float32)
        mask = np.zeros((c, s), np.float32)
        inits = np.zeros((c, k2, d), np.float32)
        for j, cell in enumerate(range(lo, hi)):
            mem = order[starts[cell]:starts[cell + 1]]
            if len(mem) == 0:
                # empty coarse cell: its words sit at the coarse centroid
                inits[j] = coarse_np[cell][None, :] + rng.normal(
                    0, 1e-3, size=(k2, d))
                continue
            take = (mem if len(mem) <= s
                    else mem[rng.permutation(len(mem))[:s]])
            samp[j, :len(take)] = xs_np[take]
            mask[j, :len(take)] = 1.0
            seed = take[rng.permutation(len(take))[:k2]]
            inits[j, :len(seed)] = xs_np[seed]
            if len(seed) < k2:  # jittered copies for cells with < k2 pts
                reps = rng.integers(0, len(seed), size=k2 - len(seed))
                inits[j, len(seed):] = (xs_np[seed[reps]]
                                        + rng.normal(0, 1e-3,
                                                     (k2 - len(seed), d)))
        cb, obj = _masked_lloyd_batch(
            torch.from_numpy(samp).to(dev), torch.from_numpy(mask).to(dev),
            torch.from_numpy(inits).to(dev), k2, fine_iters)
        fine[lo:hi] = cb.cpu().numpy()
        objs.append(obj.cpu().numpy())
    objective = torch.tensor(float(np.mean(np.concatenate(objs))),
                             device=dev)
    return HierKMeansResult(coarse, torch.from_numpy(fine).to(dev),
                            objective)


def _hier_assign_chunk(xc: torch.Tensor, coarse: torch.Tensor,
                       fine: torch.Tensor, probes: int):
    """One chunk of hierarchical assignment with multi-probe: the
    `probes` nearest coarse cells per point, an exact argmin inside each,
    the best (cell, sub) over the probes (strict improvement, so the
    earlier probe wins a tie). Returns (word ids [T] int32 = cell*K2 +
    sub, squared distance [T])."""
    k1, k2, d = fine.shape
    x_sq = torch.sum(xc * xc, -1, keepdim=True)                  # [T, 1]
    d1 = (x_sq - 2.0 * (xc @ coarse.T)
          + torch.sum(coarse * coarse, -1)[None, :])             # [T, K1]
    _, cells = top_k_smallest(d1, probes)                        # [T, P]
    f_sq = torch.sum(fine * fine, -1)                            # [K1, K2]
    best_d = torch.full((xc.shape[0],), 3.4e38, dtype=torch.float32,
                        device=xc.device)
    best_w = torch.zeros((xc.shape[0],), dtype=torch.int32, device=xc.device)
    for p in range(probes):
        cell = cells[:, p]                                       # [T]
        ip = torch.einsum("td,tkd->tk", xc, fine[cell])          # [T, K2]
        dd = x_sq - 2.0 * ip + f_sq[cell]
        a = torch.argmin(dd, -1)
        db = torch.gather(dd, -1, a[:, None])[:, 0]
        upd = db < best_d
        best_d = torch.where(upd, db, best_d)
        best_w = torch.where(upd, (cell * k2 + a).to(torch.int32), best_w)
    return best_w, torch.clamp_min(best_d, 0.0)


def hierarchical_assign(x, coarse, fine, *, probes: int = 4,
                        chunk: int = 16384, device=None):
    """Assign [N, D] points to k1*k2 hierarchical words (multi-probe).

    probes=1 is the FLANN tree descent; probes >= 4 agrees with the exact
    flat argmin over all k1*k2 words for >= 95% of points. Each probe is
    one gathered [T, K2, D] product. `device` defaults to x's own for a
    tensor, else the card."""
    dev = resolve_device(device, like=x)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    coarse = torch.as_tensor(coarse, dtype=torch.float32, device=dev)
    fine = torch.as_tensor(fine, dtype=torch.float32, device=dev)
    # bound the per-probe gathered [chunk, K2, D] working set to ~1 GB
    k1, k2, d = fine.shape
    chunk = max(256, min(chunk, (1 << 28) // max(k2 * d, 1)))
    parts = [_hier_assign_chunk(x[s:s + chunk], coarse, fine, probes)
             for s in range(0, x.shape[0], chunk)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([d for _, d in parts]))
