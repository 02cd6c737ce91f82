"""search_idle_pct.batch: device idle time inside the port's outermost
search spans, as a share of the traced slice, in %, with each batch's
operations moved onto the host clock (benchmark/spans.py); the idle time
outside them, on the same clock, is the stage table's "(caller)" row
(benchmark/stages.py)."""

from benchmark import spans


def read(ctx):
    got = spans.read(ctx)
    return None if got is None else 100.0 * got.idle_s / got.window_s
