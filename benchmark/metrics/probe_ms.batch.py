"""probe_ms.batch: device milliseconds per batch of the operations
launched inside `ivf.probe` (coarse probes, the probed table, the page
union) and `ivf.coarse_terms` (the per-segment coarse corrections)
(benchmark/spans.py)."""

from benchmark import spans

PROBE = ("ivf.probe", "ivf.coarse_terms")


def read(ctx):
    got = spans.read(ctx)
    return None if got is None else got.device_ms_per_batch(PROBE)
