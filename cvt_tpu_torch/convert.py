"""Carry `cvt_tpu` objects across to the port.

Each function takes the JAX package's parameters as numpy arrays (for
example `np.asarray(opq.rotation)`, read-only views are copied) and
returns the port's object on `device`; the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from cvt_tpu_torch.index.flat_adc import FlatADCIndex
from cvt_tpu_torch.index.ivf_adc import IVFADCIndex
from cvt_tpu_torch.quant.opq import OPQ
from cvt_tpu_torch.quant.pq import ProductQuantizer


def pq_from_numpy(codebooks, device=None) -> ProductQuantizer:
    """codebooks [M, K, ds] -> ProductQuantizer."""
    return ProductQuantizer(np.array(codebooks, np.float32), device=device)


def opq_from_numpy(rotation, codebooks, device=None) -> OPQ:
    """rotation [D, D] + codebooks [M, K, ds] -> OPQ."""
    return OPQ(np.array(rotation, np.float32),
               pq_from_numpy(codebooks, device))


def flat_adc_from_numpy(codes, dec_sq, codebooks, rotation=None,
                        device=None, impl: str = "auto") -> FlatADCIndex:
    """A `cvt_tpu` FlatADCIndex's arrays -> the port's FlatADCIndex.
    rotation None (or empty, as in a saved index) means plain PQ."""
    if rotation is None or np.asarray(rotation).size == 0:
        quant = pq_from_numpy(codebooks, device)
    else:
        quant = opq_from_numpy(rotation, codebooks, device)
    idx = FlatADCIndex(quant, impl=impl)
    idx._codes = torch.as_tensor(np.array(codes, np.uint8),
                                 device=idx.device)
    idx._dec_sq = torch.as_tensor(np.array(dec_sq, np.float32),
                                  device=idx.device)
    return idx


def ivf_adc_from_numpy(centroids, codebooks, bucket_cap=None,
                       device=None) -> IVFADCIndex:
    """A `cvt_tpu` IVFADCIndex's trained coarse quantizer (centroids
    [Kc, D]) and residual PQ (codebooks [M, K, ds]) -> the port's
    IVFADCIndex, trained and ready for build()/build_from_codes()."""
    cb = np.array(codebooks, np.float32)
    idx = IVFADCIndex(coarse_k=np.shape(centroids)[0], m=cb.shape[0],
                      k=cb.shape[1], bucket_cap=bucket_cap, device=device)
    idx.centroids = torch.as_tensor(np.array(centroids, np.float32),
                                    device=idx.device)
    idx.pq = pq_from_numpy(cb, idx.device)
    return idx
