"""The port's own stage spans in the traced slice, and the device work
that each one launched.

The port marks its stages with `utils.profile.span` ranges, named
`flat.*`, `ivf.*`, `adc.*` and `kernel.*`, which the profiler records
on the host line of the same trace as every kernel and copy, on one
clock. `split` pairs each device operation with the host call that
launched it:

  * the host runtime calls that start device work
    (`LAUNCHES`), in order of their start;
  * every device operation, in order of its start;
  * the cells run on one stream, so the calls and the operations come in
    the same order, and each operation belongs to the innermost port span
    around its call's start. Operations whose call lies in no port span
    are the caller's (key None).

The profiler can miss the device side of the first launches after it
starts (H100 traces of the three cells lost up to 12 of the first
batch's operations). So the two lists are paired from their ends, and
where one is longer its first entries stay unpaired: a lost operation had
no time in the trace to give to anyone. The pairing holds only if every
pair agrees in kind (a copy call with a copy, a set with a set, a kernel
launch with a kernel); else `split` gives None, never a guess. `read`
gives None too when the outermost search spans do not number the traced
calls, and so for a program without spans (an older checkout).

Device timestamps drift against the host's within a slice (on the H100 by
up to tens of ms over 2 s, while host ranges and runtime calls agree), so an
operation can appear to start before its call. Durations are read as
they are; only the idle time inside the search spans, which compares the
two lines, first moves each batch's operations onto the host clock: by
the smallest delay from a call to its operation's start within the batch
(the search span and the caller's code after it), which is where an
operation started right after its launch on an idle device. The caller's
idle time is read on the same moved intervals, so the two idle shares
add up to the slice's idle share on the host clock (which can differ
from `trace.idle_pct`'s, read on the device's stamps).

`read` keeps its `Split` on the run's context, so the readers of one
run share one pass over the trace.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from benchmark.trace import Event, busy_intervals

PREFIXES = ("flat.", "ivf.", "adc.", "kernel.")
SEARCH = ("flat.search", "ivf.search")
# host calls that each start one operation on the device: those the
# H100 traces of the three cells show (torch 2.11, CUDA 12.8)
LAUNCHES = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC",
                      "cudaMemcpyAsync", "cudaMemsetAsync"})


def _kind(name: str) -> str:
    return ("copy" if "Memcpy" in name else
            "set" if "Memset" in name else "kernel")


def _pairs(calls, ops):
    """Calls and operations paired from the ends, or None where a pair
    disagrees in kind."""
    n = min(len(calls), len(ops))
    calls, ops = calls[len(calls) - n:], ops[len(ops) - n:]
    if any(_kind(c.name) != _kind(o.name) for c, o in zip(calls, ops)):
        return None
    return calls, ops


def _on_host_clock(calls, ops, unpaired_ops, starts):
    """Device operations moved onto the host clock batch by batch: a call
    belongs to the last batch (search span start in `starts`) begun by
    its start, a call before the first to the first, and each batch's
    operations move by the least delay from call to start among its
    pairs. The unpaired first operations move as the first batch's."""
    def batch(t):
        return max(0, bisect.bisect_right(starts, t) - 1)
    shift: dict = {}
    for c, o in zip(calls, ops):
        b = batch(c.start)
        shift[b] = min(shift.get(b, o.start - c.start), o.start - c.start)
    moved = [(o, shift.get(0, 0.0)) for o in unpaired_ops]
    moved += [(o, shift[batch(c.start)]) for c, o in zip(calls, ops)]
    return [Event(o.name, True, o.start - d, o.end - d) for o, d in moved]


@dataclass
class Split:
    window_s: float           # the traced slice
    batches: int              # outermost search spans
    host_s: float             # their summed durations
    launches: int             # launch calls inside them
    idle_s: float             # device idle time inside them
    idle_all_s: float         # device idle time in the whole slice
    ops: int                  # device operations paired with their call
    unpaired: int             # first calls or operations left without one
    names: set = field(default_factory=set)       # port spans seen
    device_s: dict = field(default_factory=dict)  # by innermost span
    host: dict = field(default_factory=dict)      # span: [whole, itself] s

    @property
    def caller_idle_s(self) -> float:
        """Device idle time outside the search spans."""
        return self.idle_all_s - self.idle_s

    def device_ms_per_batch(self, names) -> float | None:
        """Device ms per batch of the operations owned by these spans;
        None when none of them ran."""
        if not self.batches or not any(n in self.names for n in names):
            return None
        return 1e3 * sum(self.device_s.get(n, 0.0)
                         for n in names) / self.batches


def _outermost(spans):
    out = []
    for e in sorted(spans, key=lambda e: (e.start, -e.end)):
        if not out or e.start >= out[-1].end:
            out.append(e)
    return out


def _nest(spans, times):
    """For spans that nest as they do on one host thread: the innermost
    span around each of the sorted `times` (None where none is), and each
    span name's host seconds, [whole, itself] (less the spans it holds)."""
    spans = sorted(spans, key=lambda e: (e.start, -e.end))
    stack, owners, host = [], [], {}

    def enter(e):
        while stack and stack[-1].end <= e.start:
            stack.pop()
        took = e.end - e.start
        row = host.setdefault(e.name, [0.0, 0.0])
        row[0] += took
        row[1] += took
        if stack:                     # a child: not its parent's own time
            host[stack[-1].name][1] -= took
        stack.append(e)

    j = 0
    for t in times:
        while j < len(spans) and spans[j].start <= t:
            enter(spans[j])
            j += 1
        while stack and stack[-1].end <= t:
            stack.pop()
        owners.append(stack[-1].name if stack else None)
    for e in spans[j:]:
        enter(e)
    return owners, host


def _inside(intervals, times) -> list[bool]:
    """Whether each of the sorted `times` lies in one of the sorted,
    disjoint `intervals` [start, end)."""
    out, j = [], 0
    for t in times:
        while j < len(intervals) and intervals[j][1] <= t:
            j += 1
        out.append(j < len(intervals) and intervals[j][0] <= t)
    return out


def _overlap(a, b) -> float:
    """Total length of the intersection of two sorted, disjoint interval
    lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def split(events, bounds) -> Split | None:
    """The slice's device work by port span, and its search spans' host
    time, launches and idle device time; None without a slice or when the
    launch calls and device operations do not pair."""
    if bounds is None:
        return None
    w0, w1 = bounds
    calls = sorted((e for e in events if not e.device and e.name in LAUNCHES),
                   key=lambda e: e.start)
    ops = sorted((e for e in events if e.device), key=lambda e: e.start)
    paired = _pairs(calls, ops)
    if paired is None:
        return None
    call_starts = [c.start for c in calls]
    spans = [e for e in events if not e.device and e.name.startswith(PREFIXES)
             and e.end > w0 and e.start < w1]
    searches = _outermost([e for e in spans if e.name in SEARCH])
    found = [(e.start, e.end) for e in searches]
    owners, host = _nest(spans, [c.start for c in paired[0]])
    device_s: dict = {}
    for owner, op in zip(owners, paired[1]):
        sec = max(0.0, min(op.end, w1) - max(op.start, w0))
        device_s[owner] = device_s.get(owner, 0.0) + sec
    busy = busy_intervals(_on_host_clock(
        *paired, ops[:len(ops) - len(paired[1])], [a for a, _ in found]),
        w0, w1)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return Split(window_s=w1 - w0, batches=len(searches),
                 host_s=sum(b - a for a, b in found),
                 launches=sum(_inside(found, call_starts)),
                 idle_s=_overlap(idle, found),
                 idle_all_s=sum(b - a for a, b in idle), ops=len(paired[1]),
                 unpaired=abs(len(calls) - len(ops)),
                 names={e.name for e in spans}, device_s=device_s, host=host)


def read(ctx) -> Split | None:
    """`split` of the run's traced slice, when its outermost search spans
    number the traffic loop's traced calls; kept on `ctx` for the run's
    other readers."""
    if not hasattr(ctx, "spans_split"):
        got = split(ctx.events, ctx.slice)
        ok = got is not None and got.batches == ctx.traced_calls > 0
        ctx.spans_split = got if ok else None
    return ctx.spans_split
