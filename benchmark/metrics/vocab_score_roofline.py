"""vocab_score_roofline: the least time the card could take for the
traced batches' `vocab_score_kernel` calls (benchmark/roofline/
vocab_score.py, from each batch's query images in the reference), over
the profiler's device time of the calls in the slice, in %. Where the
slice's edges cut a call away, the traced batches' mean bound stands for
each call seen."""

from benchmark.roofline import bound_seconds
from benchmark.trace import kernel_times


def read(ctx):
    peak = ctx.registry.peaks().get(ctx.kind)
    offsets = ctx.window.traced_offsets
    if ctx.slice is None or peak is None or not offsets:
        return None
    times = kernel_times(ctx.events, *ctx.slice, "vocab_score_kernel")
    if not times:
        return None
    work = ctx.registry.roofline("vocab_score").work
    b = ctx.traffic["batch"]
    n = ctx.ref.n_images
    total = 0.0
    for off in offsets:
        images = list(range(off, min(off + b, n)))
        features = int(ctx.pool.counts[off:off + b].sum())
        _, nbytes = work(ctx.ref.distinct_entries(images), features,
                         len(images), n)
        total += bound_seconds(0.0, nbytes, peak)
    return 100.0 * total / len(offsets) * len(times) / sum(times)
