"""Binary vector IO (fvecs/bvecs/ivecs) and datasets."""

from cvt_tpu_torch.io.vecs import (
    read_fvecs,
    read_bvecs,
    read_ivecs,
    write_bvecs, write_fvecs,
    write_ivecs,
)
from cvt_tpu_torch.io.datasets import synthetic_sift, load_sift1m

__all__ = [
    "read_fvecs", "read_bvecs", "read_ivecs",
    "write_bvecs", "write_fvecs", "write_ivecs",
    "synthetic_sift", "load_sift1m",
]
