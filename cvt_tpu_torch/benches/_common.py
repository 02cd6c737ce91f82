"""What the seven suites share: the command line, the JSON lines, the
timers and the result line."""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from cvt_tpu_torch.ops.kernels import launch_counts, twin_check, wrappers
from cvt_tpu_torch.utils.device import resolve_device
from cvt_tpu_torch.utils.profile import card_line, chained_time

WINDOWS = 5             # timed windows behind every median


def parse_args(argv=None, stage_help: str = "") -> tuple[list, str | None]:
    """(positional arguments, device) of `[stage ...] [--device cpu]`."""
    p = argparse.ArgumentParser()
    p.add_argument("args", nargs="*", help=stage_help)
    p.add_argument("--device", default=None,
                   help="cpu to run on the CPU (default: the card)")
    ns = p.parse_args(argv)
    return ns.args, ns.device


@contextlib.contextmanager
def full_precision():
    """float32 matrix products at full precision for the run (exact ground
    truth and k-means assignments flip near-ties under TF32), restored
    after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.set_float32_matmul_precision(prec)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def emit(lane: str, numbers: dict) -> dict:
    """Print one lane's JSON line (keys starting with '_' stay out of it)
    and return the numbers."""
    print(json.dumps({"lane": lane, **{k: v for k, v in numbers.items()
                                       if not k.startswith("_")}}),
          flush=True)
    return numbers


def spread(ms: list) -> dict:
    """The median of per-window milliseconds and [fastest, slowest]."""
    return {"ms": float(np.median(ms)), "ms_spread": [min(ms), max(ms)]}


def timed_windows(fn, stack, consts=(), windows: int | None = None) -> dict:
    """ms per iteration of fn(stack[i], *consts): `windows` windows
    (WINDOWS when None) over the whole stack, launched back to back between
    CUDA events (the host clock for a stack on the CPU), the first after
    one warm pass."""
    n = WINDOWS if windows is None else windows
    return spread([1e3 * chained_time(fn, stack, consts=consts,
                                      warmup=w == 0)
                   for w in range(n)])


def host_ms(fn, dev: torch.device) -> dict:
    """Host-clock ms of fn() through a synchronize, WINDOWS times after one
    warm call."""
    fn()
    sync(dev)
    ms = []
    for _ in range(WINDOWS):
        t0 = time.perf_counter()
        fn()
        sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
    return spread(ms)


def kernel_lane(name: str, args: tuple, bound: dict, dev: torch.device,
                iters: int) -> dict:
    """Kernel `name`'s wrapper alone on a lane's own arguments (as
    `ops.kernels.recorded_args` gives them): ms of `iters` launches back to
    back, median of WINDOWS windows, beside the card's bound for the call
    and its share of it (None off the card); then the kernel against its
    twin on the same arguments (`ops.kernels.twin_check`, which raises on
    a difference), its result under "twin"."""
    fn = wrappers()[name]
    t = timed_windows(lambda _: fn(*args), torch.zeros(iters, device=dev))
    return {"kernel_ms": t["ms"], "kernel_ms_spread": t["ms_spread"],
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bound_share": (bound["bound_ms"] / t["ms"]
                            if dev.type == "cuda" else None),
            "twin": twin_check(name, args)}


def peak_mib(dev: torch.device) -> float | None:
    """Peak device memory since the last reset (None on the CPU)."""
    if dev.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev) / 2 ** 20


def reset_peak(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


class Run:
    """One suite's run on `device` (the card unless asked for the CPU):
    the launch counts at its start, and its result line at its end."""

    def __init__(self, suite: str, device=None):
        self.suite = suite
        self.dev = resolve_device(device)
        self.launches0 = launch_counts()
        self.t0 = time.perf_counter()

    def result(self, **fields) -> dict:
        """Print the last line: the suite's fields, the device, the kernel
        launches during the run and the run's seconds."""
        r = {"suite": self.suite, **fields,
             "device": (card_line(self.dev) if self.dev.type == "cuda"
                        else "cpu"),
             "kernel_launches": {n: c - self.launches0[n]
                                 for n, c in launch_counts().items()},
             "seconds": time.perf_counter() - self.t0}
        print(json.dumps(r), flush=True)
        return r
