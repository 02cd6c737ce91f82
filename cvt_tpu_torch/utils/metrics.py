"""Quality metrics: recall@k (the reference's recall harness).

recall@k mirrors hnsw_sifts_retrieval/makeIdx.cpp:231-285 (test_approx /
test_vs_recall): fraction of queries whose true nearest neighbor appears
in the returned top-k.
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
