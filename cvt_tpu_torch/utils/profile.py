"""Profiling observability (counterpart of `cvt_tpu.utils.profile`).

The reference instruments with ad-hoc wall-clock prints
(opq/train_codebook/train_PQ_codebook.cpp:161-169, util/timer.h). Here:

  * `trace(logdir)` — context manager over torch.profiler (CPU and, where
    there is a card, CUDA activities), writing a TensorBoard trace of
    every operator and kernel into `logdir`;
  * `chained_time(fn, stack)` — steady-state seconds per iteration of
    `fn` over `stack`'s leading axis, the iterations launched back to
    back between two CUDA events with one synchronize at the end (the
    host clock for a stack on the CPU, whose operators run synchronously);
  * `roofline(flops, bytes_accessed, seconds)` — achieved TFLOP/s and
    device-memory GB/s of a measured kernel invocation;
  * `measure_launch_overhead()` — the round trip of one trivial launch
    and a synchronize, to subtract from one-shot host-clock timings.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch

from cvt_tpu_torch.utils.device import resolve_device


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace context (TensorBoard format, in `logdir`);
    yields the profiler, whose `key_averages()` sums operators by name."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def chained_time(fn, stack, *, consts=(), warmup: bool = True) -> float:
    """Seconds per iteration of `fn(stack[i], *consts)` for i over the
    leading axis of `stack` (a tensor; its device decides the clock).

    On the card the iterations are launched back to back between two
    CUDA events, and one synchronize ends the run, so the figure is device
    time without per-iteration host round trips. A warm-up pass over the
    whole stack runs first unless `warmup` is False."""
    stack = torch.as_tensor(stack)
    iters = stack.shape[0]

    def run():
        for i in range(iters):
            fn(stack[i], *consts)

    if warmup:
        run()
    if stack.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(stack.device)
        start.record()
        run()
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) / 1e3
    else:
        t0 = time.perf_counter()
        run()
        seconds = time.perf_counter() - t0
    return max(seconds, 1e-9) / iters


@dataclass
class Roofline:
    tflops: float
    hbm_gbps: float

    def __str__(self) -> str:
        return f"{self.tflops:.1f} TFLOP/s, {self.hbm_gbps:.0f} GB/s"


def roofline(flops: float, bytes_accessed: float, seconds: float) -> Roofline:
    return Roofline(tflops=flops / seconds / 1e12,
                    hbm_gbps=bytes_accessed / seconds / 1e9)


def measure_launch_overhead(device=None) -> float:
    """Seconds for one trivial launch plus a synchronize (the card unless
    asked for the CPU, `utils.device`). Subtract from one-shot
    host-clock timings."""
    dev = resolve_device(device)
    x = torch.zeros((8, 128), dtype=torch.float32, device=dev)

    def once():
        nonlocal x
        x = x + 1.0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    once()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    return (time.perf_counter() - t0) / reps
