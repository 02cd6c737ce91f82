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
stand in for `lax.map` / `lax.scan`. The coarse level is the
hand-written `vocab_coarse` kernel (ops/kernels/vocab_coarse.py) on the
card (its plain twin on the CPU); given uint8 points and a tree of integer words
(`integer_tree`), the fine level is the hand-written `vocab_descend`
kernel (ops/kernels/vocab_descend.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from cvt_tpu_torch.ops.kernels import vocab_coarse as _coarse
from cvt_tpu_torch.ops.kernels import vocab_descend as _descend
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


def _hier_assign_gathered(xc: torch.Tensor, coarse: torch.Tensor,
                          fine: torch.Tensor, probes: int):
    """The per-point form of `_hier_assign_chunk`: each probe gathers
    every point's own [K2, D] block (a [T, K2, D] copy a probe), the
    `probes` nearest coarse cells per point, an exact argmin inside each,
    the best (cell, sub) over the probes (strict improvement, so the
    earlier probe wins a tie). Kept as the grouped form's plain
    reference. Returns (word ids [T] int32 = cell*K2 + sub, squared
    distance [T])."""
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


# rows of (point, probe) pairs scored against one cell's block per GEMM
# tile (the descent kernel's tile), and the bound on one step's [tiles,
# rows, K2] float32 scores
_TILE_ROWS = _descend.TILE
_STEP_BYTES = 1 << 29


def _augmented_fine(fine: torch.Tensor) -> torch.Tensor:
    """[K1, K2, D'] = [-2 fine | ||fine||^2 | 0 ...], D' = D + 4, so that
    one product with [x | 1 | 0 ...] gives ||f||^2 - 2<x, f> (the 0
    columns keep rows 16-byte aligned)."""
    k1, k2, d = fine.shape
    out = torch.zeros((k1, k2, d + 4), dtype=fine.dtype, device=fine.device)
    out[..., :d] = -2.0 * fine
    out[..., d] = torch.sum(fine * fine, -1)
    return out


class IntegerTree(NamedTuple):
    """The fine words of a tree whose words are all integers in 0-255, as
    the descent kernel takes them (`integer_tree`)."""
    words: torch.Tensor  # [K1, K2, D] uint8
    fsq: torch.Tensor    # [K1, K2] int32: ||f||^2


def integer_tree(fine: torch.Tensor) -> IntegerTree | None:
    """`fine` [K1, K2, D] float32 as uint8 words and int32 squared norms
    where every word is an integer in 0-255 and the descent kernel takes
    the shape, else None. A word equals its uint8 cast only if it is such
    an integer, so one compare over the cast checks the whole tree."""
    k1, k2, d = fine.shape
    if not _descend.shape_ok(d, k2):
        return None
    words = fine.to(torch.uint8)
    if not bool((words == fine).all()):
        return None
    return IntegerTree(words.contiguous(),
                       torch.sum(fine * fine, -1).to(torch.int32))


def _pair_tiles(cells: torch.Tensor, k1: int):
    """The (point, probe) pairs p = point * P + probe sorted by cell
    (`order` [T * P] int64, on the cells' device) and cut into tiles of at
    most `_TILE_ROWS` pairs of one cell: each tile's cell, first position
    in `order` and pair count (numpy int64 [G]). One host sync (the
    cells' counts)."""
    flat = cells.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=k1).cpu().numpy()
    per = -(-counts // _TILE_ROWS)
    tile_cell = np.repeat(np.arange(k1), per)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tile0 = np.concatenate([[0], np.cumsum(per)[:-1]])
    row0 = first[tile_cell] + (np.arange(len(tile_cell))
                               - tile0[tile_cell]) * _TILE_ROWS
    count = np.minimum(first[tile_cell] + counts[tile_cell] - row0,
                       _TILE_ROWS)
    return order, tile_cell, row0, count


def _cell_argmin(xc: torch.Tensor, cells: torch.Tensor, fa: torch.Tensor):
    """For every (point, probe) pair, the first nearest word inside its
    cell: (||f||^2 - 2<x, f> of it [T, P], its sub id [T, P] int64).

    The pairs are sorted by cell and cut into tiles of at most
    `_TILE_ROWS` rows of one cell (`_pair_tiles`); each step scores a run
    of tiles against their cells' blocks as one batched GEMM, so a cell's
    block is read once a tile, not once a point."""
    t, p = cells.shape
    k1, k2, da = fa.shape
    dev = xc.device
    n = t * p
    order, tile_cell, row0, count = _pair_tiles(cells, k1)
    lane = torch.arange(_TILE_ROWS, device=dev)[None, :]
    pos = torch.from_numpy(row0).to(dev)[:, None] + lane
    valid = lane < torch.from_numpy(count).to(dev)[:, None]
    pair = torch.where(valid, order[pos.clamp_max(max(n - 1, 0))], n)
    # [x | 1 | 0 ...]; row t, all zeros, stands in for a tile's empty rows
    xa = torch.zeros((t + 1, da), dtype=xc.dtype, device=dev)
    xa[:t, :xc.shape[1]] = xc
    xa[:t, xc.shape[1]] = 1.0
    tcell = torch.from_numpy(tile_cell).to(dev)
    dist = torch.empty(n + 1, dtype=xc.dtype, device=dev)
    sub = torch.empty(n + 1, dtype=torch.int64, device=dev)
    step = max(1, _STEP_BYTES // (_TILE_ROWS * k2 * 4))
    for lo in range(0, len(tile_cell), step):
        pr = pair[lo:lo + step]                                  # [G, R]
        xt = xa[torch.div(pr, p, rounding_mode="floor").clamp_max(t)]
        dd = torch.bmm(xt, fa[tcell[lo:lo + step]].mT)           # [G, R, K2]
        v, a = torch.min(dd, -1)
        dist[pr.reshape(-1)] = v.reshape(-1)
        sub[pr.reshape(-1)] = a.reshape(-1)
    return dist[:n].reshape(t, p), sub[:n].reshape(t, p)


def _cell_argmin_u8(rows: torch.Tensor, cells: torch.Tensor,
                    tree: IntegerTree):
    """`_cell_argmin` for uint8 rows [T, D] on an integer tree, as one
    `vocab_descend` call over the same tiles: (||f||^2 - 2<x, f> [T, P]
    float32, sub id [T, P] int32), exact, so equal to `_cell_argmin`'s
    bits (every product and partial sum there is an integer below 2^24)."""
    t, p = cells.shape
    order, tile_cell, row0, count = _pair_tiles(cells, tree.words.shape[0])
    tiles = torch.from_numpy(np.stack([tile_cell, row0, count], 1).astype(
        np.int32)).to(rows.device)
    dist, sub = _descend.vocab_descend(rows.contiguous(), order, tiles,
                                       tree.words, tree.fsq, p)
    return dist.float().reshape(t, p), sub.reshape(t, p)


def _hier_assign_chunk(xc: torch.Tensor, coarse: torch.Tensor,
                       fine: torch.Tensor, probes: int, fa=None, tree=None,
                       rows=None):
    """One chunk of hierarchical assignment with multi-probe: the
    `probes` nearest coarse cells per point (`vocab_coarse`: the kernel
    on the card, which takes D up to 128 and probes up to 16, its twin on
    the CPU), an exact argmin inside each (the first minimum), the best
    (cell, sub) over the probes (strict improvement, so the earlier probe
    wins a tie). The argmins are taken grouped by cell: given `tree`
    (`integer_tree(fine)`) and `rows` (xc as uint8) by the descent kernel
    (`_cell_argmin_u8`), else in float32 (`_cell_argmin`; `fa` is
    `_augmented_fine(fine)`, made here when not given). Returns (word
    ids [T] int32 = cell*K2 + sub, squared distance [T]).

    The distances are those of `_hier_assign_gathered` up to float32
    summation order: ||f||^2 enters the GEMM's sum as its last term, and
    ||x||^2 is added to each cell's minimum."""
    k2 = fine.shape[1]
    x_sq = torch.sum(xc * xc, -1, keepdim=True)                  # [T, 1]
    _, cells = _coarse.vocab_coarse(xc.contiguous(), coarse,
                                    probes)                      # [T, P]
    if tree is not None and rows is not None:
        dmin, sub = _cell_argmin_u8(rows, cells, tree)
    else:
        dmin, sub = _cell_argmin(xc, cells, _augmented_fine(fine)
                                 if fa is None else fa)
    dist = x_sq + dmin                                           # [T, P]
    best_d = torch.full((xc.shape[0],), 3.4e38, dtype=torch.float32,
                        device=xc.device)
    best_w = torch.zeros((xc.shape[0],), dtype=torch.int32, device=xc.device)
    for p in range(probes):
        db = dist[:, p]
        upd = db < best_d
        best_d = torch.where(upd, db, best_d)
        best_w = torch.where(upd, (cells[:, p] * k2 + sub[:, p]).to(
            torch.int32), best_w)
    return best_w, torch.clamp_min(best_d, 0.0)


def hierarchical_assign(x, coarse, fine, *, probes: int = 4,
                        chunk: int | None = None, device=None, tree=None,
                        rows=None):
    """Assign [N, D] points to k1*k2 hierarchical words (multi-probe).

    probes=1 is the FLANN tree descent; probes >= 4 agrees with the exact
    flat argmin over all k1*k2 words for >= 95% of points. The (point,
    probe) pairs of a chunk of `chunk` points (by default about 2M pairs)
    are grouped by cell, so each cell's [K2, D] block is read once a tile
    of up to 512 pairs: by the float32 GEMMs of `_cell_argmin`, or, given
    both `tree` (`integer_tree(fine)`) and `rows` (the points as uint8
    [N, D], on x's device), by the descent kernel `vocab_descend`. Both
    give the same bits where both apply. `device` defaults to x's own for
    a tensor, else the card."""
    dev = resolve_device(device, like=x)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    coarse = torch.as_tensor(coarse, dtype=torch.float32, device=dev)
    fine = torch.as_tensor(fine, dtype=torch.float32, device=dev)
    if chunk is None:
        chunk = max(256, (1 << 21) // max(probes, 1))
    if tree is None or rows is None:
        tree = rows = None
    elif rows.dtype != torch.uint8 or rows.shape != x.shape:
        raise ValueError(f"hierarchical_assign: rows must be uint8 of x's "
                         f"shape {tuple(x.shape)}, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    fa = _augmented_fine(fine) if tree is None else None
    parts = [_hier_assign_chunk(
        x[s:s + chunk], coarse, fine, probes, fa, tree,
        None if rows is None else rows[s:s + chunk])
        for s in range(0, x.shape[0], chunk)]
    return (torch.cat([w for w, _ in parts]),
            torch.cat([d for _, d in parts]))
