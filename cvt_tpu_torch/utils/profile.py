"""Profiling observability (counterpart of `cvt_tpu.utils.profile`).

The reference instruments with ad-hoc wall-clock prints
(opq/train_codebook/train_PQ_codebook.cpp:161-169, util/timer.h). Here:

  * `trace(logdir)` — context manager over torch.profiler (CPU and, where
    there is a card, CUDA activities), writing a TensorBoard trace of
    every operator and kernel into `logdir`;
  * `span(name)` — a named host range around one stage of the port,
    recorded into the running torch.profiler's own trace beside its
    kernels and copies, and a shared no-op while none runs;
  * `chained_time(fn, stack)` — steady-state seconds per iteration of
    `fn` over `stack`'s leading axis, the iterations launched back to
    back between two CUDA events with one synchronize at the end (the
    host clock for a stack on the CPU, whose operators run synchronously);
  * `roofline(flops, bytes_accessed, seconds)` — achieved TFLOP/s and
    device-memory GB/s of a measured kernel invocation;
  * `measure_launch_overhead()` — the round trip of one trivial launch
    and a synchronize, to subtract from one-shot host-clock timings;
  * `card_line(device)` — the card's name and power limit as nvidia-smi
    prints them, to stand beside every number taken on it;
  * `bound(ops, nbytes[, peak])`, `adc_bound(args, cached)`,
    `ivf_bound(args)` — the least time one H100 could take for a kernel
    call's work (its operations over their peak, int8's by default, or
    its bytes over the memory rate, whichever is larger), from the call's
    own arguments.
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from dataclasses import dataclass

import torch
from torch.autograd import profiler as _autograd_profiler

from cvt_tpu_torch.utils.device import resolve_device

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:          # an older torch: spans are never recorded
    _RecordFunctionFast = None

# H100 SXM data sheet: dense int8 tensor-core rate, HBM3 bandwidth
PEAK_INT8_OPS, HBM_BYTES_PER_S = 1.979e15, 3.35e12


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


_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager naming one stage of the port in a profiler trace.

    While a torch.profiler records, it enters a FUNCTION-scope range (the
    kind an aten operator gets): it lands on the host line of the trace
    that holds every kernel and copy, on the clock of the host operators
    and runtime calls, and it gets no mirror interval on the device line
    (a `record_function` range gets one). Otherwise it returns one shared
    no-op context, at well under a microsecond a span. The test is
    torch's own process-wide "profiler started" flag (a module attribute,
    cheaper to read than the per-thread `_profiler_enabled()` call), so a
    span on another host thread records whenever the profiler records
    that thread (`profile_all_threads`). A span's parent is the span that
    encloses it on the same host thread."""
    if _RecordFunctionFast is None or \
            not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _RecordFunctionFast(name)


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


def card_line(device=0) -> str:
    """'<name>, <power limit>' of a card (an index or a CUDA device), as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
    prints it."""
    index = device if isinstance(device, int) else (
        torch.device(device).index or 0)
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip()


def bound(ops: float, nbytes: float, peak: float = PEAK_INT8_OPS) -> dict:
    """The least time for the work: bytes over the memory rate or
    operations over their peak (int8's unless `peak` is given), whichever
    is larger, and which."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops": ops, "bytes": nbytes}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def adc_bound(args, cached: bool) -> dict:
    """Bound of one `adc_segmin` (cached=False) or `adc_segmin_cached`
    call on its arguments: every padded row against every padded query,
    the inputs read once, segpack and tiletop written once."""
    q2s = args[0]
    bpad, d = q2s.shape
    n_in = 4 if cached else 5
    npad = args[2].shape[1] if cached else args[2].shape[0]
    tile_n = args[n_in + 1]
    seg = args[n_in + 2] if len(args) > n_in + 2 else 128
    out = 4 * bpad * (npad // seg + 8 * (npad // tile_n))
    return bound(2.0 * npad * d * bpad, nbytes(*args[:n_in]) + out)


def live_slots(args) -> int:
    """The live page slots of an `ivf_page` call: its n_live argument
    (capped at sel's length), or every slot where it has none."""
    n_slots = args[5].shape[0]
    if len(args) < 9 or args[8] is None:
        return n_slots
    return min(int(args[8]), n_slots)


def ivf_bound(args) -> dict:
    """Bound of one `ivf_page` call, counting the live page slots only:
    their cache rows and norms, coarse terms and minima, plus the
    queries. The kernel skips the fill slots past n_live."""
    q2s, _, _, _, _, sel, lp, seg = args[:8]
    bpad, d = q2s.shape
    n_live = live_slots(args)
    mins = n_live * (lp // seg) * bpad * 4
    return bound(2.0 * n_live * lp * d * bpad,
                 n_live * lp * (d + 4) + 2 * mins + nbytes(q2s, sel))
