"""The vocabulary tree's own stage spans in the traced slice, and the
device work each one launched: benchmark/spans.py's pairing of launch
calls with device operations (`spans._pairs`, `_nest`, `_outermost`),
for the port's `vocab.*` spans with `vocab.search` as the outermost, one
a batch (spans.py itself knows the `flat.`, `ivf.`, `adc.` and `kernel.`
spans of the ADC searches).

`read` gives None for a program without these spans (an older checkout),
when the calls and operations do not pair, or when the outermost spans do
not number the traffic loop's traced calls.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from benchmark import spans

PREFIXES = ("vocab.", "kernel.")
SEARCH = "vocab.search"
# besides spans.LAUNCHES: the driver API's launch, which H100 traces of
# this cell show once in 2 slices of 6 (one kernel a slice)
LAUNCHES = spans.LAUNCHES | {"cuLaunchKernel", "cuLaunchKernelEx"}


@dataclass
class Split:
    batches: int                                  # outermost search spans
    names: set = field(default_factory=set)       # port spans seen
    device_s: dict = field(default_factory=dict)  # by innermost span

    def device_ms_per_batch(self, names) -> float | None:
        """Device ms per batch of the operations owned by these spans;
        None when none of them ran."""
        if not self.batches or not any(n in self.names for n in names):
            return None
        return 1e3 * sum(self.device_s.get(n, 0.0)
                         for n in names) / self.batches


def split(events, bounds) -> Split | None:
    if bounds is None:
        return None
    w0, w1 = bounds
    calls = sorted((e for e in events
                    if not e.device and e.name in LAUNCHES),
                   key=lambda e: e.start)
    ops = sorted((e for e in events if e.device), key=lambda e: e.start)
    paired = spans._pairs(calls, ops)
    if paired is None:
        return None
    marks = [e for e in events if not e.device and e.name.startswith(PREFIXES)
             and e.end > w0 and e.start < w1]
    searches = spans._outermost([e for e in marks if e.name == SEARCH])
    owners, _ = spans._nest(marks, [c.start for c in paired[0]])
    device_s: dict = {}
    for owner, op in zip(owners, paired[1]):
        sec = max(0.0, min(op.end, w1) - max(op.start, w0))
        device_s[owner] = device_s.get(owner, 0.0) + sec
    return Split(batches=len(searches), names={e.name for e in marks},
                 device_s=device_s)


def read(ctx) -> Split | None:
    """`split` of the run's traced slice, kept on `ctx` for the run's other
    readers."""
    if not hasattr(ctx, "vocab_split"):
        got = split(ctx.events, ctx.slice)
        ok = got is not None and got.batches == ctx.traced_calls > 0
        ctx.vocab_split = got if ok else None
    return ctx.vocab_split
