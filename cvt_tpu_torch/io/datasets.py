"""Dataset helpers: SIFT1M loader + a synthetic SIFT-like generator.

Both are numpy and produce the same arrays as `cvt_tpu.io.datasets` for
the same arguments, so the two packages can be held against each other on
identical data.
"""

from __future__ import annotations

import os

import numpy as np

from cvt_tpu_torch.io.vecs import read_bvecs, read_fvecs, read_ivecs

# the repository's own (git-ignored) data directory
_SIFT1M_CANDIDATES = (
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "_data", "sift1m"),
)


def load_sift1m(root: str | None = None):
    """Load SIFT1M (base, query, groundtruth) if present on disk, else None.

    Expects TexMex layout: sift_base.fvecs / sift_query.fvecs /
    sift_groundtruth.ivecs (or the sift/ subdirectory naming). Without
    `root`, looks in the repository's `_data/sift1m`.
    """
    roots = [root] if root else list(_SIFT1M_CANDIDATES)
    for r in roots:
        if not r or not os.path.isdir(r):
            continue
        for prefix in ("sift_", "sift/sift_"):
            base = os.path.join(r, prefix + "base.fvecs")
            if os.path.exists(base):
                q = read_fvecs(os.path.join(r, prefix + "query.fvecs"))
                gt = read_ivecs(os.path.join(r, prefix + "groundtruth.ivecs"))
                return read_fvecs(base), q, gt
            base = os.path.join(r, prefix + "base.bvecs")
            if os.path.exists(base):
                b = read_bvecs(base).astype(np.float32)
                q = read_bvecs(
                    os.path.join(r, prefix + "query.bvecs")).astype(np.float32)
                gt = read_ivecs(os.path.join(r, prefix + "groundtruth.ivecs"))
                return b, q, gt
    return None


def synthetic_sift(n: int, d: int = 128, *, n_queries: int = 0,
                   n_clusters: int | None = None, seed: int = 0,
                   query_mode: str = "fresh", query_noise: float = 6.0,
                   dtype=np.float32):
    """SIFT-like synthetic data: mixture of clusters, non-negative,
    heavy-tailed, scaled to SIFT's typical magnitude.

    n_clusters defaults to max(256, n // 16) so nearest-neighbor gaps
    stay meaningful at scale (with few clusters, same-cluster points
    differ only by iid noise and no compact code can rank them — recall
    would measure the generator, not the index).

    query_mode:
      * 'fresh' (default): queries are INDEPENDENT draws from the same
        mixture — the honest recall regime (a query's nearest neighbor is
        a genuinely different point, like SIFT1M's held-out query set).
      * 'perturbed': queries are noisy copies of base points
        (near-duplicate retrieval); recall numbers in this mode are
        optimistic and must be labeled as such.
    """
    rng = np.random.default_rng(seed)
    if n_clusters is None:
        n_clusters = max(256, n // 16)
    centers = rng.gamma(shape=1.2, scale=24.0, size=(n_clusters, d))

    def draw(m):
        ci = rng.integers(0, n_clusters, size=m)
        x = centers[ci] + rng.normal(0.0, 12.0, size=(m, d))
        return np.clip(x, 0.0, 255.0).astype(dtype)

    base = draw(n)
    if n_queries:
        if query_mode == "fresh":
            q = draw(n_queries)
        elif query_mode == "perturbed":
            src = rng.integers(0, n, size=n_queries)
            q = base[src] + rng.normal(0.0, query_noise, size=(n_queries, d))
            q = np.clip(q, 0.0, 255.0).astype(dtype)
        else:
            raise ValueError(f"unknown query_mode {query_mode!r}")
        return base, q
    return base
