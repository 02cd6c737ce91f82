"""search_host_ms.batch: host milliseconds per batch inside the port's
outermost search span (`flat.search`, `ivf.search`), from entry to return,
over the traced slice's batches (benchmark/spans.py). It is read under the
profiler, whose per-operation hooks it includes, and it bounds a batch's
time only where the host does: a search that returns once its work is
queued leaves the device's time to its caller."""

from benchmark import spans


def read(ctx):
    got = spans.read(ctx)
    return None if got is None else 1e3 * got.host_s / got.batches
