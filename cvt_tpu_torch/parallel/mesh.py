"""Device meshes over torch.distributed ranks.

Counterpart of `cvt_tpu.parallel.mesh`, with the same axis convention:
  'dp' — query/data parallelism: query batches and k-means training data
         are split here;
  'db' — database sharding: the PQ code matrix [N, M] is split along N
         here, and per-shard top-k results are merged over this axis.

One process drives one device (the JAX package's one process drives all
of its host's devices). A mesh is a `DeviceMesh` over the ranks of the
default process group in rank order, row-major over the axes, so each
'db' group of a ('dp', 'db') mesh holds consecutive ranks, as the JAX
mesh lays `jax.devices()` out. `init_distributed` starts the group.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(axis_sizes: dict[str, int] | None = None,
              device_type: str | None = None) -> DeviceMesh:
    """A DeviceMesh with named axes over every rank of the default group.
    Default: one 'db' axis over all ranks; device_type defaults to 'cuda'
    under an NCCL group and 'cpu' under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed() first")
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"db": world}
    total = math.prod(axis_sizes.values())
    if total != world:
        raise ValueError(f"mesh {axis_sizes} needs {total} ranks, the "
                         f"group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type,
                            tuple(axis_sizes.values()),
                            mesh_dim_names=tuple(axis_sizes))


def cpu_mesh(axis_sizes: dict[str, int]) -> DeviceMesh:
    """A mesh of CPU ranks (a gloo group): multi-shard layouts without a
    card, as the JAX package's virtual CPU devices give them."""
    return make_mesh(axis_sizes, device_type="cpu")


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device in `mesh`: its current CUDA device (set by
    init_distributed) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]
