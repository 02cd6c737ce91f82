"""Vector codecs: PQ, OPQ."""

from cvt_tpu_torch.quant.pq import ProductQuantizer
from cvt_tpu_torch.quant.opq import OPQ

__all__ = ["ProductQuantizer", "OPQ"]
