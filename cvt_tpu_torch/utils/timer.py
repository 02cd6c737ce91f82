"""Wall-clock timing spans, replacing the reference's StopW / gettimeofday
prints (hnsw_sifts_retrieval/makeIdx.cpp:82-98, train_PQ_codebook.cpp:161-169)
with a context manager that waits for the card before it stops the clock
(counterpart of `cvt_tpu.utils.timer`: `torch.cuda.synchronize` on the
devices of the observed CUDA tensors in place of `jax.block_until_ready`),
so that asynchronous launches do not fake the numbers."""

from __future__ import annotations

import time

import torch


def _cuda_devices(result) -> set:
    """The CUDA devices of the tensors in a (nested) tuple, list or dict."""
    if isinstance(result, torch.Tensor):
        return {result.device} if result.is_cuda else set()
    if isinstance(result, dict):
        result = list(result.values())
    if isinstance(result, (list, tuple)):
        return set().union(*(_cuda_devices(r) for r in result))
    return set()


class Timer:
    def __init__(self, name: str = "", sync: bool = True,
                 verbose: bool = False):
        self.name = name
        self.sync = sync
        self.verbose = verbose
        self.elapsed = 0.0
        self._result = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def observe(self, result):
        """Register tensors (or a tuple / list / dict of them) to wait for
        before stopping the clock."""
        self._result = result
        return result

    def __exit__(self, *exc):
        if self.sync and self._result is not None:
            for dev in _cuda_devices(self._result):
                torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"[timer] {self.name}: {self.elapsed * 1e3:.2f} ms")
        return False
