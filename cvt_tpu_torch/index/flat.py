"""Exact flat index — the `brute_force_search` equivalent and the
ground-truth engine of every recall harness (counterpart of
`cvt_tpu.index.flat`)."""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.ops.topk import chunked_topk_scan
from cvt_tpu_torch.utils.device import resolve_device


class FlatIndex:
    """Exact top-k search over an uncompressed float database.

    metric: 'l2' (squared L2) or 'ip' (inner product; returned distances
    are negated IPs so smaller = closer, matching hnswlib's convention).
    """

    def __init__(self, dim: int, metric: str = "l2", chunk: int = 65536,
                 device=None):
        if metric not in ("l2", "ip"):
            raise ValueError(f"unknown metric {metric!r}")
        self.dim = dim
        self.metric = metric
        self.chunk = chunk
        self.device = resolve_device(device)
        self._db: torch.Tensor | None = None

    @property
    def ntotal(self) -> int:
        return 0 if self._db is None else self._db.shape[0]

    def add(self, x) -> None:
        """Append vectors [n, dim] to the database."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.ndim != 2 or x.shape[1] != self.dim:
            raise ValueError(f"expected [n, {self.dim}], got {tuple(x.shape)}")
        self._db = x if self._db is None else torch.cat([self._db, x], 0)

    def search(self, q, k: int):
        """q: [B, dim] -> (dists [B, k] f32, ids [B, k] i32)."""
        if self._db is None:
            raise RuntimeError("empty index")
        q = torch.as_tensor(q, dtype=torch.float32, device=self.device)
        k = min(k, self.ntotal)
        return chunked_topk_scan(q, self._db, k, self.metric,
                                 min(self.chunk, self._db.shape[0]))

    # -- persistence ------------------------------------------------------
    def save(self, path: str) -> None:
        np.savez(path, db=self._db.cpu().numpy(), metric=self.metric,
                 dim=self.dim)

    @classmethod
    def load(cls, path: str, device=None) -> "FlatIndex":
        z = np.load(path, allow_pickle=False)
        idx = cls(int(z["dim"]), str(z["metric"]), device=device)
        idx.add(z["db"])
        return idx
