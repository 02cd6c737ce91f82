"""vocab_match_roofline: the least time the card could take for the
traced batches' `vocab_match_kernel` calls (benchmark/roofline/
vocab_match.py, from each batch's query images, their candidates, the
entries those candidates hold on the walked lists and their records in
the reference), over the profiler's device time of the
calls in the slice, in %. Each call of a batch walks the whole batch, so
the traced batches' mean bound stands for each call seen. None where the
kernel never ran (a program without it)."""

import torch

from benchmark.roofline import bound_seconds
from benchmark.trace import kernel_times


def read(ctx):
    peak = ctx.registry.peaks().get(ctx.kind)
    offsets = ctx.window.traced_offsets
    if ctx.slice is None or peak is None or not offsets:
        return None
    times = kernel_times(ctx.events, *ctx.slice, "vocab_match_kernel")
    if not times:
        return None
    work = ctx.registry.roofline("vocab_match").work
    b = ctx.traffic["batch"]
    ref = ctx.ref
    n = ref.base.n_images
    bound = {}
    for off in set(offsets):
        images = torch.arange(off, min(off + b, n),
                              device=ref.frames.device)
        cands = ref.candidates(images)
        _, nbytes = work(ref.base.distinct_entries(images),
                         ref.candidate_entries(images, cands),
                         int(ctx.pool.counts[off:off + b].sum()),
                         len(images), n, ref.records(images, cands))
        bound[off] = bound_seconds(0.0, nbytes, peak)
    total = sum(bound[off] for off in offsets)
    return 100.0 * total / len(offsets) * len(times) / sum(times)
