"""Inputs of a run, made from its seed on the run's device.

The base vectors and the queries follow the mixture of
`cvt_tpu_torch.io.datasets.synthetic_sift` (gamma centres, N // 16
clusters, Gaussian noise of 12, clipped to 0-255), rewritten to draw in a
few large calls from a `torch.Generator` on the device, and rounded to
integers as SIFT's values are. Queries are fresh draws from the same
mixture.

The trained quantizer is an input too, as a deployment loads one trained
offline: a random orthogonal rotation and per-subspace k-means codebooks
(flat OPQ), or coarse k-means centroids and residual codebooks (IVF). It is
made here with plain code, handed to the program and to the reference
alike. Every k-means takes the same number of steps on every seed, and its
sums are taken in an order that does not depend on the device's atomics,
so one seed gives one quantizer.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

CHUNK = 262_144          # rows drawn per call


def seed_for(seed: int, tag: str) -> int:
    """A 63-bit seed of its own for each input, from the run's seed."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def sync(dev) -> None:
    """Wait for the device's queued work (a timing's end)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_for(seed, tag))


def mixture_centres(seed: int, n: int, d: int, device) -> torch.Tensor:
    g = generator(seed, "centres", device)
    alpha = torch.full((max(256, n // 16), d), 1.2, device=device)
    return torch._standard_gamma(alpha, generator=g) * 24.0


def draw(centres: torch.Tensor, m: int, g: torch.Generator) -> torch.Tensor:
    """m rows of the mixture [m, d] float32, integer-valued in 0-255."""
    nc, d = centres.shape
    out = torch.empty((m, d), dtype=torch.float32, device=centres.device)
    for s in range(0, m, CHUNK):
        t = min(CHUNK, m - s)
        ci = torch.randint(0, nc, (t,), generator=g, device=centres.device)
        x = centres[ci] + 12.0 * torch.randn(
            (t, d), generator=g, device=centres.device)
        out[s:s + t] = torch.clamp(x, 0.0, 255.0).round()
    return out


def base_vectors(seed: int, n: int, d: int, device) -> torch.Tensor:
    centres = mixture_centres(seed, n, d, device)
    return draw(centres, n, generator(seed, "base", device))


def query_pool(seed: int, n_base: int, d: int, n: int,
               device) -> np.ndarray:
    """n fresh queries [n, d] float32 in host memory, where a caller keeps
    its queries."""
    centres = mixture_centres(seed, n_base, d, device)
    q = draw(centres, n, generator(seed, "queries", device))
    return q.cpu().numpy()


# ------------------------------------------------------------ k-means

def _assign(x: torch.Tensor, c: torch.Tensor, block: int) -> torch.Tensor:
    """Nearest centroid of each row of x [n, d] among c [K, d] (float32
    products, TF32 off), in blocks of rows."""
    c_sq = torch.sum(c * c, dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for s in range(0, x.shape[0], block):
        xb = x[s:s + block]
        out[s:s + block] = torch.argmin(c_sq[None] - 2.0 * xb @ c.T, dim=1)
    return out


def _means(x: torch.Tensor, a: torch.Tensor, old: torch.Tensor):
    """Cluster means of x [n, d] by assignment a [n] in float64, summed
    by a sort and a cumulative sum (no atomics, so the same on every run);
    an empty cluster keeps its old centroid."""
    k = old.shape[0]
    order = torch.argsort(a, stable=True)
    counts = torch.bincount(a, minlength=k)
    # the scan runs along the last axis, where the device parallelises it
    cs = torch.cumsum(x[order].double().T, dim=1)                # [d, n]
    cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], 1)
    ends = torch.cumsum(counts, 0)
    sums = (cs[:, ends] - cs[:, ends - counts]).T
    mean = (sums / counts.clamp_min(1)[:, None]).float()
    return torch.where((counts > 0)[:, None], mean, old).contiguous()


def kmeans(x: torch.Tensor, k: int, iters: int, g: torch.Generator,
           block: int = 32_768) -> torch.Tensor:
    """Lloyd's k-means on x [n, d] from k distinct rows drawn by g;
    returns the centroids [k, d] float32."""
    init = torch.randperm(x.shape[0], generator=g, device=x.device)[:k]
    c = x[init].clone()
    for _ in range(iters):
        c = _means(x, _assign(x, c, block), c)
    return c


def pq_codebooks(y: torch.Tensor, m: int, k: int, iters: int,
                 g: torch.Generator, block: int = 65_536) -> torch.Tensor:
    """Per-subspace k-means codebooks [m, k, d / m] of y [n, d]: the m
    subspaces' Lloyd steps taken together, each from the same k rows."""
    n, d = y.shape
    ds = d // m
    xs = y.reshape(n, m, ds).permute(1, 0, 2).contiguous()       # [m, n, ds]
    init = torch.randperm(n, generator=g, device=y.device)[:k]
    c = xs[:, init].clone()                                      # [m, k, ds]
    off = (torch.arange(m, device=y.device) * k)[:, None]
    for _ in range(iters):
        c_sq = torch.sum(c * c, dim=-1)[:, None, :]              # [m, 1, k]
        a = torch.empty((m, n), dtype=torch.int64, device=y.device)
        for s in range(0, n, block):
            ip = torch.bmm(xs[:, s:s + block], c.transpose(1, 2))
            a[:, s:s + block] = torch.argmin(c_sq - 2.0 * ip, dim=-1)
        c = _means(xs.reshape(m * n, ds), (a + off).reshape(-1),
                   c.reshape(m * k, ds)).reshape(m, k, ds)
    return c


def rotation(d: int, g: torch.Generator) -> torch.Tensor:
    """A random orthogonal matrix [d, d]: the Q of a Gaussian's QR, with
    its columns' signs fixed by R's diagonal so that it is unique."""
    a = torch.randn((d, d), generator=g, device=g.device,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))[None, :]).float()


def training_sample(x: torch.Tensor, n: int,
                    g: torch.Generator) -> torch.Tensor:
    idx = torch.randperm(x.shape[0], generator=g, device=x.device)[:n]
    return x[idx]


def flat_quantizer(seed: int, base: torch.Tensor, q: dict):
    """(rotation [D, D], codebooks [M, K, D / M]) of the flat OPQ index."""
    g = generator(seed, "quantizer", base.device)
    rot = rotation(base.shape[1], g)
    y = training_sample(base, q["train_rows"], g) @ rot
    return rot, pq_codebooks(y, q["m"], q["k"], q["iters"], g)


def ivf_quantizer(seed: int, base: torch.Tensor, q: dict):
    """(coarse centroids [Kc, D], residual codebooks [m, K, D / m])."""
    g = generator(seed, "quantizer", base.device)
    x = training_sample(base, q["train_rows"], g)
    cent = kmeans(x, q["coarse_k"], q["coarse_iters"], g)
    resid = x - cent[_assign(x, cent, 32_768)]
    return cent, pq_codebooks(resid, q["m"], q["k"], q["iters"], g)
