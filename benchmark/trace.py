"""The traced slice of a `--trace 1` run, and what is read from it.

`Tracer` runs `torch.profiler` (CPU and CUDA activities) over a steady
slice of the measured window: from 30% of the window for 2 seconds (or
40% of a shorter window), started and stopped between two calls of the
traffic loop, and marked by a `bench.slice` annotation whose host
interval is the traced window. The trace stays in memory. `events()`
flattens it into `Event`s; the functions below read device busy time,
time per operation and the idle gaps from them.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import torch

SLICE = "bench.slice"


@dataclass
class Event:
    name: str
    device: bool          # True: a kernel, copy or set on the card
    start: float          # seconds, on the profiler's clock
    end: float


class Tracer:
    def __init__(self, enabled: bool, seconds: float):
        self.enabled = enabled
        self.start_at = 0.3 * seconds
        self.stop_at = self.start_at + min(2.0, 0.4 * seconds)
        self.prof = None
        self.mark = None
        self.done = False
        self.calls = 0            # calls of the traffic loop inside the slice

    def warm(self) -> None:
        """Profile a trivial step once during set-up, so that the
        profiler's own start-up does not fall into the window."""
        if self.enabled:
            with _profiler():
                torch.ones(8).sum()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def tick(self, elapsed: float) -> None:
        """Called before each call of the loop, with the window's age."""
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed >= self.start_at:
            self.prof = _profiler()
            self.prof.start()
            self.mark = torch.profiler.record_function(SLICE)
            self.mark.__enter__()
        elif self.prof is not None and elapsed >= self.stop_at:
            self.stop()
        if self.active:
            self.calls += 1

    def stop(self) -> None:
        if self.prof is not None and not self.done:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.mark.__exit__(None, None, None)
            self.prof.stop()
            self.done = True

    def events(self) -> list[Event]:
        return [] if self.prof is None else profile_events(self.prof)


def _profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def profile_events(prof) -> list[Event]:
    """Every event of a stopped profiler as an `Event`."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = e.device_type() != torch.autograd.DeviceType.CPU
        if dev and e.name() == SLICE:
            continue          # the annotation's mirror on the device's line
        if hasattr(e, "start_ns"):
            s, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
        else:
            s, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
        out.append(Event(e.name(), dev, s, s + dur))
    return out


def window(events: list[Event]) -> tuple[float, float] | None:
    """The host interval of the slice's annotation."""
    marks = [e for e in events if not e.device and e.name == SLICE]
    if not marks:
        return None
    return marks[0].start, marks[0].end


def _clip(events, w0, w1):
    return [(max(e.start, w0), min(e.end, w1), e.name) for e in events
            if e.device and e.end > w0 and e.start < w1]


def busy_intervals(events: list[Event], w0: float, w1: float):
    """The union of the device's intervals inside [w0, w1], merged."""
    merged: list[list[float]] = []
    for s, e, _ in sorted(_clip(events, w0, w1)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_seconds(events: list[Event], w0: float, w1: float) -> float:
    return sum(e - s for s, e in busy_intervals(events, w0, w1))


def idle_pct(events: list[Event], bounds) -> float | None:
    """The share of the slice (w0, w1) with nothing running on the
    device, in %; None without a traced slice."""
    if bounds is None:
        return None
    w0, w1 = bounds
    return 100.0 * (1.0 - busy_seconds(events, w0, w1) / (w1 - w0))


def op_seconds(events: list[Event], w0: float, w1: float) -> dict:
    """Device seconds per operation name inside the window."""
    out: dict[str, float] = {}
    for s, e, name in _clip(events, w0, w1):
        out[name] = out.get(name, 0.0) + (e - s)
    return out


def kernel_times(events: list[Event], w0: float, w1: float,
                 kernel: str) -> list[float]:
    """Durations of every launch whose name holds `kernel` as a word
    (so `adc_segmin_kernel` does not match `adc_segmin_cached_kernel`)."""
    out = []
    for e in events:
        if e.device and w0 <= e.start < w1 and _names(e.name, kernel):
            out.append(e.end - e.start)
    return out


def _names(full: str, kernel: str) -> bool:
    i = full.find(kernel)
    while i >= 0:
        before = full[i - 1] if i else " "
        after = full[i + len(kernel)] if i + len(kernel) < len(full) else " "
        if not (before.isalnum() or before == "_") and not (
                after.isalnum() or after == "_"):
            return True
        i = full.find(kernel, i + 1)
    return False


def idle_gaps(events: list[Event], w0: float, w1: float) -> dict:
    """Idle seconds of the device inside the window, summed by the host
    operation running at the middle of each gap (the innermost one; the
    slice's own annotation when nothing else runs)."""
    host = sorted((e for e in events if not e.device
                   and e.end > w0 and e.start < w1),
                  key=lambda e: e.start)
    busy = busy_intervals(events, w0, w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    out: dict[str, float] = {}
    running: list = []                    # heap of (end, index) of host ops
    nxt = 0
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while nxt < len(host) and host[nxt].start <= mid:
            heapq.heappush(running, (host[nxt].end, nxt))
            nxt += 1
        while running and running[0][0] < mid:
            heapq.heappop(running)
        inner = [host[i] for _, i in running]
        name = min(inner, key=lambda e: e.end - e.start).name if inner \
            else "(no host operation)"
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def short(name: str) -> str:
    """A kernel's name without its argument list and namespace noise."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(", 1)[0][:120] or name[:120]


def top(d: dict, n: int = 10) -> list:
    """The n largest entries, names shortened (entries that shorten to one
    name are summed)."""
    out: dict[str, float] = {}
    for k, v in d.items():
        out[short(k)] = out.get(short(k), 0.0) + v
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]
