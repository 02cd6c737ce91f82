"""Utilities: quality metrics, the device rule of the entry points."""

from cvt_tpu_torch.utils.device import resolve_device
from cvt_tpu_torch.utils.metrics import recall_at_k

__all__ = ["recall_at_k", "resolve_device"]
