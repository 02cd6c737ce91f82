"""Binary vector IO: fvecs/bvecs/ivecs, the cvt record format, and
datasets."""

from cvt_tpu_torch.io.vecs import (
    read_fvecs,
    read_bvecs,
    read_ivecs,
    write_bvecs, write_fvecs,
    write_ivecs,
    read_cvt_records,
    write_cvt_records,
)
from cvt_tpu_torch.io.datasets import synthetic_sift, load_sift1m

__all__ = [
    "read_fvecs", "read_bvecs", "read_ivecs",
    "write_bvecs", "write_fvecs", "write_ivecs",
    "read_cvt_records", "write_cvt_records",
    "synthetic_sift", "load_sift1m",
]
