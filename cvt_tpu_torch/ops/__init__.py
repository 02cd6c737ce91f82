"""Core tensor operations: normalization, distances, top-k, k-means."""

from cvt_tpu_torch.ops.linalg import (
    l2_normalize,
    pairwise_l2sq,
    pairwise_ip,
    pairwise_distance,
)
from cvt_tpu_torch.ops.topk import (top_k_smallest, top_k_largest,
                                    merge_topk, chunked_topk_scan)
from cvt_tpu_torch.ops.kmeans import (kmeans, kmeans_assign, KMeansResult,
                                     hierarchical_kmeans, hierarchical_assign,
                                     HierKMeansResult)

__all__ = [
    "l2_normalize",
    "pairwise_l2sq",
    "pairwise_ip",
    "pairwise_distance",
    "top_k_smallest",
    "top_k_largest",
    "merge_topk",
    "chunked_topk_scan",
    "kmeans",
    "kmeans_assign",
    "KMeansResult",
    "hierarchical_kmeans",
    "hierarchical_assign",
    "HierKMeansResult",
]
