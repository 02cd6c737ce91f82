"""Data-parallel k-means over a device mesh.

Counterpart of `cvt_tpu.parallel.distributed_kmeans`: one Lloyd step runs
data-parallel over the mesh's 'dp' axis. Every rank assigns its own shard
of the training set (one matrix product), computes partial one-hot sums
and counts, and one all_reduce(SUM) over the 'dp' group replaces JAX's
psum. Empty centroids stay in place.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import mesh_device


def _local_step(x, centroids, *, group):
    """x: this rank's shard [n_local, D]; centroids [K, D], the same on
    every rank. Returns (new_centroids [K, D], mean objective), the same
    on every rank."""
    k, d = centroids.shape
    c_sq = torch.sum(centroids * centroids, dim=-1)
    dist_ = (torch.sum(x * x, dim=-1, keepdim=True)
             - 2.0 * (x @ centroids.T) + c_sq[None, :])
    assign = torch.argmin(dist_, dim=-1)
    best = torch.clamp_min(torch.gather(dist_, -1, assign[:, None])[:, 0],
                           0.0)
    onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
    # one collective for all four partial statistics
    stats = torch.cat([(onehot.T @ x).reshape(-1), torch.sum(onehot, dim=0),
                       torch.sum(best)[None],
                       torch.tensor([float(x.shape[0])], device=x.device)])
    dist.all_reduce(stats, op=dist.ReduceOp.SUM, group=group)
    sums = stats[:k * d].reshape(k, d)
    counts = stats[k * d:k * d + k]
    obj, total = stats[-2], stats[-1]
    new_c = sums / torch.clamp_min(counts, 1.0)[:, None]
    new_c = torch.where((counts < 0.5)[:, None], centroids, new_c)
    return new_c, obj / total


def sharded_kmeans_step(mesh: DeviceMesh, x, centroids, *, axis: str = "dp"):
    """One data-parallel Lloyd step. x is THIS rank's shard [n_local, D]
    (the JAX function's sharded [N, D] as one rank sees it), centroids the
    same [K, D] on every rank. Returns (new_centroids, mean_sq_dist), the
    same on every rank. A tensor x keeps its device; numpy goes to this
    rank's device in the mesh."""
    dev = x.device if isinstance(x, torch.Tensor) else mesh_device(mesh)
    return _local_step(torch.as_tensor(x, dtype=torch.float32, device=dev),
                       torch.as_tensor(centroids, dtype=torch.float32,
                                       device=dev),
                       group=mesh.get_group(axis))
