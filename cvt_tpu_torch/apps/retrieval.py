"""Image-level retrieval over local descriptors: vote + rerank
(counterpart of `cvt_tpu.apps.retrieval`).

Reference: the hnsw_sifts_retrieval app — makeIdx.cpp indexes every
RootSIFT descriptor of every image into one HNSW graph with a geometry
sidecar (:299-399), makeSearch.cpp queries per descriptor, filters by
distance < 0.1 and keypoint-angle difference < 10 degrees, counts votes
per image (:52-62), then SVF-reranks the top images (:66-107).

The per-descriptor kNN runs on any port index with add/search (exact
`FlatIndex` by default, squared L2 as in `cvt_tpu`). Votes aggregate with
one scatter-add over image ids; the top candidates' match sets are
gathered for all candidates at once and re-ranked by SVF or RANSAC in one
batched call. Every selection takes `jax.lax.top_k`'s tie order
(`ops/topk`); the final order is a stable sort, as `jnp.argsort`'s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from cvt_tpu_torch.features.covdet import SiftFeatures
from cvt_tpu_torch.index.flat import FlatIndex
from cvt_tpu_torch.match.ransac import ransac
from cvt_tpu_torch.match.svf import svf_inliers
from cvt_tpu_torch.ops.topk import top_k_largest
from cvt_tpu_torch.utils.device import resolve_device


def _row(x, batch_index: int, device) -> torch.Tensor:
    return torch.as_tensor(x[batch_index], device=device)


@dataclass
class ImageRetrievalIndex:
    """Flat store of all images' descriptors + keypoint geometry.

    `device`: where the store lives (default the card; `device="cpu"` asks
    for the CPU). Images are buffered by `add_image` and handed to the
    index in one `add` before the next search."""

    dim: int = 128
    metric: str = "l2"
    index: object = None            # any port index with add/search
    device: object = None
    _img_ids: list = field(default_factory=list)
    _frames: list = field(default_factory=list)
    _names: list = field(default_factory=list)
    _pending: list = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.index is None:
            self.index = FlatIndex(self.dim, self.metric, device=self.device)

    @property
    def n_images(self) -> int:
        return len(self._names)

    def add_image(self, feats: SiftFeatures, name: str | None = None,
                  batch_index: int = 0) -> int:
        """Add one image's features (one batch row of extract_sift)."""
        v = _row(feats.valid, batch_index, self.device).to(torch.bool)
        desc = _row(feats.descriptors, batch_index, self.device)[v]
        frames = _row(feats.frames, batch_index, self.device)[v]
        img_id = self.n_images
        self._pending.append(desc.to(torch.float32))
        self._img_ids.append(torch.full((desc.shape[0],), img_id,
                                        dtype=torch.int64,
                                        device=self.device))
        self._frames.append(frames.to(torch.float32))
        self._names.append(name if name is not None else f"img_{img_id}")
        self._finalized = False
        return img_id

    def _finalize(self):
        if getattr(self, "_finalized", False):
            return
        pending = [d for d in self._pending if d.shape[0]]
        if pending:
            self.index.add(torch.cat(pending))
        self._pending = []
        self._all_ids = torch.cat(self._img_ids)
        self._all_frames = torch.cat(self._frames)
        self._finalized = True

    def search(self, feats: SiftFeatures, *, topk: int = 10,
               k_per_desc: int = 5, max_dist: float = 0.1,
               angle_thresh_deg: float = 10.0, batch_index: int = 0,
               rerank: str | None = "svf", rerank_depth: int = 10,
               rerank_matches: int = 64, gen: torch.Generator | None = None):
        """Query with one image's features.

        Returns (names, scores): candidate image names ranked by vote
        count (and rerank inlier count when rerank is 'svf'/'ransac').
        max_dist follows makeSearch.cpp:55 (squared-distance 0.1 on
        RootSIFT); angle filter mirrors the |da| < 10 degree check.
        `gen` seeds RANSAC's sampling (None: seed 0).
        """
        self._finalize()
        dev = self.device
        v = _row(feats.valid, batch_index, dev).to(torch.bool)
        qdesc = _row(feats.descriptors, batch_index, dev)[v]
        qframes = _row(feats.frames, batch_index, dev)[v].to(torch.float32)
        if qdesc.shape[0] == 0:
            return [], np.zeros(0, np.float32)

        d, nn = self.index.search(qdesc, k_per_desc)     # [Kq, kpd]
        nn = nn.to(torch.int64)
        nn_img = self._all_ids[nn]                       # [Kq, kpd]
        nn_frames = self._all_frames[nn]                 # [Kq, kpd, 4]
        da = torch.rad2deg(torch.abs(qframes[:, None, 3] - nn_frames[..., 3]))
        da = torch.minimum(torch.remainder(da, 360.0),
                           360.0 - torch.remainder(da, 360.0))
        good = (d < max_dist) & (da < angle_thresh_deg)

        votes = torch.zeros(self.n_images, dtype=torch.float32, device=dev)
        votes.index_add_(0, nn_img.reshape(-1),
                         good.reshape(-1).to(torch.float32))
        nshow = min(topk if rerank is None else max(topk, rerank_depth),
                    self.n_images)
        vote_scores, cand = top_k_largest(votes, nshow)

        if rerank is None:
            names = [self._names[i] for i in cand[:topk].tolist()]
            return names, vote_scores[:topk].cpu().numpy()

        # ---- rerank: fixed-slot match sets, all candidates at once -----
        r = min(rerank_matches, qdesc.shape[0])
        m = good & (nn_img == cand[:, None, None])       # [C, Kq, kpd]
        # best db hit per query descriptor for each candidate image
        dm = torch.where(m, d, math.inf)
        bd, best = torch.min(dm, -1)                     # [C, Kq], first min
        ok = torch.isfinite(bd)
        sel_frames = nn_frames[torch.arange(qdesc.shape[0], device=dev),
                               best]                     # [C, Kq, 4]
        score = torch.where(ok, -bd, -math.inf)
        _, pick = top_k_largest(score, r)                # [C, R]
        f1 = qframes[pick]                               # [C, R, 4]
        f2 = torch.gather(sel_frames, 1, pick[..., None].expand(-1, -1, 4))
        mval = torch.gather(ok, 1, pick)

        if rerank == "svf":
            inl = svf_inliers(f1[..., :2], f1[..., 3], f2[..., :2],
                              f2[..., 3], mval)
            rr_scores = torch.sum(inl, -1).to(torch.float32)
        elif rerank == "ransac":
            res = ransac(gen, f1[..., :2], f2[..., :2], mval,
                         model="affine", threshold=8.0, n_hypotheses=64)
            rr_scores = res.n_inliers.to(torch.float32)
        else:
            raise ValueError(f"unknown rerank {rerank!r}")

        # stable re-sort: inlier count first, votes as tiebreak
        combined = rr_scores * 1e4 + vote_scores
        order = torch.argsort(-combined, stable=True)[:topk]
        return ([self._names[i] for i in cand[order].tolist()],
                rr_scores[order].cpu().numpy())
