"""Multi-device layer: sharded ADC search, serving and distributed
k-means over torch.distributed (NCCL on cards, gloo on the CPU), one
process per device."""

from cvt_tpu_torch.parallel.mesh import make_mesh, cpu_mesh
from cvt_tpu_torch.parallel.sharded_search import ShardedADCSearcher
from cvt_tpu_torch.parallel.distributed_kmeans import sharded_kmeans_step
from cvt_tpu_torch.parallel.serving import (MultiHostADCServer, QueryBatcher,
                                            init_distributed, serving_mesh,
                                            ring_merge_topk)

__all__ = ["make_mesh", "cpu_mesh", "ShardedADCSearcher",
           "sharded_kmeans_step", "MultiHostADCServer", "QueryBatcher",
           "init_distributed", "serving_mesh", "ring_merge_topk"]
