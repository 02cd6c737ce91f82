"""Scene utilities: clustering, visibility pyramid, graph cuts.

Reference: retrieval/vlindex/src/base/{scene_clustering, visibility_
pyramid, graph_cut}.{h,cc}. These back COLMAP's hierarchical mapper and
next-best-view selection; they complete the SURVEY #14 base inventory.

The reference's Metis/BGL graph machinery becomes SPECTRAL partitioning
— the normalized graph Laplacian's Fiedler vector from one dense host
eigh (image match graphs are small: thousands of nodes), recursively
applied. The s-t min-cut is a host-side BFS max-flow (graphs are tiny
and irregular — the reference links a whole Boykov-Kolmogorov library
for this). Host numpy throughout: the counterpart of
`cvt_tpu.match.scene_graph_utils`, copied (the port imports nothing of
the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


def normalized_cut(edges, weights, n_nodes: int):
    """Bipartition node ids [0, n) by the normalized-cut spectral
    relaxation (base/graph_cut.cc ComputeNormalizedMinGraphCut's role).

    edges [E, 2] int, weights [E] float. Returns labels [n] in {0, 1}.
    """
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    w = np.asarray(weights, np.float64).reshape(-1)
    a = np.zeros((n_nodes, n_nodes), np.float64)
    a[edges[:, 0], edges[:, 1]] = w
    a[edges[:, 1], edges[:, 0]] = w
    d = a.sum(1)
    dn = 1.0 / np.sqrt(np.maximum(d, 1e-12))
    lap = np.eye(n_nodes) - (a * dn[None, :]) * dn[:, None]
    vals, vecs = np.linalg.eigh(lap)          # small graphs: host eigh
    fiedler = vecs[:, 1] if n_nodes > 1 else np.zeros(1)
    # threshold at the median for a balanced cut
    return (fiedler > np.median(fiedler)).astype(np.int32)


def min_st_cut(edges, capacities, n_nodes: int, s: int, t: int):
    """BFS (Edmonds-Karp) s-t max-flow / min-cut
    (base/graph_cut.cc ComputeMinGraphCutStoerWagner's s-t sibling).
    Returns (cut_value, labels [n] with 1 = source side)."""
    cap = np.zeros((n_nodes, n_nodes), np.float64)
    edges = np.asarray(edges, np.int64).reshape(-1, 2)
    for (u, v), c in zip(edges, np.asarray(capacities, np.float64)):
        cap[u, v] += c
        cap[v, u] += c                         # undirected
    flow = 0.0
    while True:
        parent = np.full(n_nodes, -1, np.int64)
        parent[s] = s
        queue = [s]
        while queue and parent[t] == -1:
            u = queue.pop(0)
            for v in np.nonzero(cap[u] > 1e-12)[0]:
                if parent[v] == -1:
                    parent[v] = u
                    queue.append(v)
        if parent[t] == -1:
            break
        # augment along the path
        path, v = [], t
        while v != s:
            path.append((parent[v], v))
            v = parent[v]
        aug = min(cap[u][v] for u, v in path)
        for u, v in path:
            cap[u, v] -= aug
            cap[v, u] += aug
        flow += aug
    reach = np.zeros(n_nodes, bool)
    reach[s] = True
    queue = [s]
    while queue:
        u = queue.pop(0)
        for v in np.nonzero((cap[u] > 1e-12) & ~reach)[0]:
            reach[v] = True
            queue.append(v)
    return flow, reach.astype(np.int32)


@dataclass
class SceneCluster:
    image_ids: list
    children: list = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children

    def leaves(self):
        if self.is_leaf:
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out


def cluster_scene(image_ids, edges, weights, *, leaf_max_images: int = 100,
                  image_overlap: int = 0) -> SceneCluster:
    """Recursive bipartition of the image match graph
    (base/scene_clustering.{h,cc}: Options.leaf_max_num_images /
    image_overlap). edges index into image_ids; weights = match counts.
    Overlapping images are the strongest cross-cut pairs' endpoints,
    duplicated into both children like the reference."""
    image_ids = list(image_ids)
    n = len(image_ids)
    root = SceneCluster(image_ids)
    if n <= leaf_max_images:
        return root
    labels = normalized_cut(edges, weights, n)
    idx0 = [i for i in range(n) if labels[i] == 0]
    idx1 = [i for i in range(n) if labels[i] == 1]
    if not idx0 or not idx1:                   # degenerate: no split
        return root
    # overlap duplication must strictly SHRINK both children or the
    # recursion never reaches the leaf base case (fixed point ~
    # 2*image_overlap when image_overlap >= leaf_max_images/2)
    if max(len(idx0), len(idx1)) + image_overlap >= n:
        return root
    # cross-cut edges sorted by weight: duplicate endpoints as overlap
    over0, over1 = [], []
    if image_overlap > 0:
        cross = [(w, e) for e, w in zip(np.asarray(edges), weights)
                 if labels[e[0]] != labels[e[1]]]
        for w, e in sorted(cross, key=lambda p: -p[0]):
            a, b = int(e[0]), int(e[1])
            if labels[a] == 1:
                a, b = b, a
            if len(over0) < image_overlap and b not in over0:
                over0.append(b)
            if len(over1) < image_overlap and a not in over1:
                over1.append(a)
            if (len(over0) >= image_overlap
                    and len(over1) >= image_overlap):
                break

    def child(own, extra):
        keep = set(own) | set(extra)
        sub_ids = [image_ids[i] for i in own] + [image_ids[i]
                                                for i in extra]
        remap = {g: j for j, g in enumerate(own + extra)}
        sub_e, sub_w = [], []
        for e, w in zip(np.asarray(edges), weights):
            a, b = int(e[0]), int(e[1])
            if a in keep and b in keep:
                sub_e.append((remap[a], remap[b]))
                sub_w.append(w)
        return cluster_scene(sub_ids, np.asarray(sub_e or [[0, 0]]),
                             sub_w or [0.0],
                             leaf_max_images=leaf_max_images,
                             image_overlap=image_overlap)

    root.children = [child(idx0, over0), child(idx1, over1)]
    return root


class VisibilityPyramid:
    """Multi-resolution observation-coverage score
    (base/visibility_pyramid.{h,cc}): an image's score grows when its
    3D-point observations cover NEW cells at fine pyramid levels —
    COLMAP's next-best-view ranking signal."""

    def __init__(self, num_levels: int = 6, width: int = 1024,
                 height: int = 1024):
        self.num_levels = num_levels
        self.width = max(width, 1)
        self.height = max(height, 1)
        self._grids = [np.zeros((1 << lv, 1 << lv), np.int32)
                       for lv in range(1, num_levels + 1)]
        self.score = 0
        # per-level score weight 2^(2*level) like the reference
        self._w = [1 << (2 * lv) for lv in range(1, num_levels + 1)]

    def _cell(self, lv, x, y):
        n = 1 << (lv + 1)
        cx = min(int(x * n / self.width), n - 1)
        cy = min(int(y * n / self.height), n - 1)
        return cy, cx

    def add_point(self, x: float, y: float) -> None:
        for lv, g in enumerate(self._grids):
            cy, cx = self._cell(lv, x, y)
            if g[cy, cx] == 0:
                self.score += self._w[lv]
            g[cy, cx] += 1

    def remove_point(self, x: float, y: float) -> None:
        for lv, g in enumerate(self._grids):
            cy, cx = self._cell(lv, x, y)
            g[cy, cx] -= 1
            if g[cy, cx] == 0:
                self.score -= self._w[lv]
