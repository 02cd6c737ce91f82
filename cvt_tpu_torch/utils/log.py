"""Structured logging, CHECK helpers, and an LRU cache (counterpart of
`cvt_tpu.utils.log`, framework-free).

Reference: retrieval/vlindex/src/util/logging.h:37-64 (glog CHECK
macros + the non-aborting CHECK_OPTION family used by every options
Check() method) and util/cache.h (LRUCache keyed loader cache, used by
FeatureMatcherCache). Python's logging module plays glog's role with a
glog-style line format; CHECK helpers raise instead of aborting
(exceptions are the Python analogue of glog's FATAL) while the
check_option family returns bool exactly like the reference's
CHECK_OPTION macros.
"""

from __future__ import annotations

import logging
import sys
import threading
from collections import OrderedDict
from typing import Callable, Generic, Hashable, TypeVar

_LOG = logging.getLogger("cvt_tpu_torch")


def init_logging(level: int = logging.INFO,
                 stream=None) -> logging.Logger:
    """Configure the cvt_tpu_torch logger with a glog-style line format
    (InitializeGlog's role, util/logging.h:64). Idempotent."""
    if not _LOG.handlers:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(levelname).1s%(asctime)s.%(msecs)03d %(threadName)s "
            "%(filename)s:%(lineno)d] %(message)s",
            datefmt="%m%d %H:%M:%S"))
        _LOG.addHandler(h)
    _LOG.setLevel(level)
    return _LOG


def get_logger() -> logging.Logger:
    return _LOG


class CheckError(AssertionError):
    """Raised by the check() family (glog CHECK's FATAL analogue)."""


def check(cond, msg: str = "", *vals) -> None:
    """CHECK(cond): raise CheckError with the formatted message."""
    if not cond:
        raise CheckError(msg % vals if vals else (msg or "check failed"))


def _binop(name: str, op: Callable[[object, object], bool]):
    def f(a, b, msg: str = "") -> None:
        if not op(a, b):
            raise CheckError(
                f"check_{name} failed: {a!r} vs {b!r}"
                + (f" ({msg})" if msg else ""))
    f.__name__ = f"check_{name}"
    return f


check_eq = _binop("eq", lambda a, b: a == b)
check_ne = _binop("ne", lambda a, b: a != b)
check_le = _binop("le", lambda a, b: a <= b)
check_lt = _binop("lt", lambda a, b: a < b)
check_ge = _binop("ge", lambda a, b: a >= b)
check_gt = _binop("gt", lambda a, b: a > b)


def check_option(cond, expr: str = "") -> bool:
    """Non-aborting option check (CHECK_OPTION, logging.h:43-47):
    logs and returns False on failure — for config Check() methods."""
    if not cond:
        _LOG.error("check option failed: %s", expr or "<option>")
        return False
    return True


K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


class LRUCache(Generic[K, V]):
    """Bounded least-recently-used cache with an optional loader
    (util/cache.h LRUCache: Get pulls through the getter function and
    evicts the LRU entry past max_num_elems). Thread-safe."""

    def __init__(self, max_num_elems: int,
                 getter: Callable[[K], V] | None = None):
        check_gt(max_num_elems, 0, "cache capacity")
        self._cap = max_num_elems
        self._getter = getter
        self._d: OrderedDict[K, V] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key: K) -> bool:
        with self._lock:
            return key in self._d

    def get(self, key: K) -> V:
        """Fetch (loading through the getter on miss); marks key MRU."""
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.hits += 1
                return self._d[key]
            if self._getter is None:
                raise KeyError(key)
            self.misses += 1
        value = self._getter(key)      # load outside the lock
        self.set(key, value)
        return value

    def set(self, key: K, value: V) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)

    def pop(self, key: K) -> V | None:
        with self._lock:
            return self._d.pop(key, None)

    def clear(self) -> None:
        with self._lock:
            self._d.clear()
