"""search_launches.batch: host calls that start device work (kernel
launches, copies, sets) per batch inside the port's outermost search
spans (benchmark/spans.py)."""

from benchmark import spans


def read(ctx):
    got = spans.read(ctx)
    return None if got is None else got.launches / got.batches
