"""Utilities: quality metrics."""

from cvt_tpu_torch.utils.metrics import recall_at_k

__all__ = ["recall_at_k"]
