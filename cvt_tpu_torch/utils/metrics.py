"""Quality metrics: recall@k (the reference's recall harness) and AUC.

recall@k mirrors hnsw_sifts_retrieval/makeIdx.cpp:231-285 (test_approx /
test_vs_recall): fraction of queries whose true nearest neighbor appears
in the returned top-k. auc mirrors ctr/compute_auc.py:8-51 (exact
pairwise AUC, cross-checked there against sklearn).
"""

from __future__ import annotations

import numpy as np


def recall_at_k(pred_ids, gt_ids, k: int | None = None,
                gt_count: int = 1) -> float:
    """pred_ids [B, >=k] predicted neighbor ids; gt_ids [B] or [B, G]
    ground-truth ids (numpy arrays or CPU/GPU tensors). Returns mean
    fraction of the first `gt_count` ground-truth neighbors found in each
    query's top-k list."""
    pred = _to_numpy(pred_ids)
    gt = _to_numpy(gt_ids)
    if gt.ndim == 1:
        gt = gt[:, None]
    gt = gt[:, :gt_count]
    if k is not None:
        pred = pred[:, :k]
    hits = (pred[:, None, :] == gt[:, :, None]).any(axis=-1)  # [B, G]
    return float(hits.mean())


def _to_numpy(a) -> np.ndarray:
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def auc(labels, scores) -> float:
    """Exact AUC via rank statistics (equivalent to the O(P*N) pairwise
    count in ctr/compute_auc.py, computed in O(n log n)). Labels and
    scores are numpy arrays or tensors."""
    labels = _to_numpy(labels).astype(bool)
    scores = _to_numpy(scores).astype(np.float64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(labels.size, dtype=np.float64)
    sorted_scores = scores[order]
    # Average ranks over ties (1-based), as the pairwise definition
    # counts ties as 0.5.
    i = 0
    r = np.arange(1, labels.size + 1, dtype=np.float64)
    while i < labels.size:
        j = i
        while j + 1 < labels.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        r[i:j + 1] = 0.5 * (i + 1 + j + 1)
        i = j + 1
    ranks[order] = r
    return float((ranks[labels].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))
