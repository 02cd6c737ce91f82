"""select_ms.batch: device milliseconds per batch of the operations
launched inside the port's selection spans: `adc.select` (the flat
kernel search's phase 2: tile candidates to the top k), or `ivf.rescore`
and `ivf.select` (the winning segments rescored, then the top k)
(benchmark/spans.py)."""

from benchmark import spans

SELECT = ("adc.select", "ivf.rescore", "ivf.select")


def read(ctx):
    got = spans.read(ctx)
    return None if got is None else got.device_ms_per_batch(SELECT)
