"""Vector codecs: int8 scalar quantization, PQ, OPQ, PCA."""

from cvt_tpu_torch.quant.sq import ScalarQuantizer
from cvt_tpu_torch.quant.pq import ProductQuantizer
from cvt_tpu_torch.quant.opq import OPQ
from cvt_tpu_torch.quant.pca import PCA

__all__ = ["ScalarQuantizer", "ProductQuantizer", "OPQ", "PCA"]
