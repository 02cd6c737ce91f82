"""Utilities: quality metrics, timers, profiling, the device rule of the
entry points, logging, CHECK helpers and the LRU cache."""

from cvt_tpu_torch.utils.device import resolve_device
from cvt_tpu_torch.utils.log import (CheckError, LRUCache, check, check_eq,
                                     check_ge, check_gt, check_le, check_lt,
                                     check_ne, check_option, get_logger,
                                     init_logging)
from cvt_tpu_torch.utils.metrics import auc, recall_at_k
from cvt_tpu_torch.utils.profile import (chained_time,
                                         measure_launch_overhead, roofline,
                                         span, trace)
from cvt_tpu_torch.utils.timer import Timer

__all__ = ["recall_at_k", "auc", "Timer", "trace", "span", "chained_time",
           "roofline", "measure_launch_overhead", "resolve_device",
           "CheckError", "LRUCache", "check", "check_eq", "check_ge",
           "check_gt", "check_le", "check_lt", "check_ne", "check_option",
           "get_logger", "init_logging"]
