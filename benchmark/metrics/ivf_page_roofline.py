"""ivf_page_roofline: the least time the card could take for the traced
batches' `ivf_page_kernel` calls, counted from what each batch's queries
need (benchmark/roofline/ivf_page.py: each query's own probed rows, the
union of the batch's probed cells; probes and cell sizes from the
reference), over the profiler's device time of those calls, in %."""

import torch

from benchmark.roofline import bound_seconds
from benchmark.trace import kernel_times


def read(ctx):
    peak = ctx.registry.peaks().get(ctx.kind)
    offsets = ctx.window.traced_offsets
    if ctx.slice is None or peak is None or not offsets:
        return None
    times = kernel_times(ctx.events, *ctx.slice, "ivf_page_kernel")
    if len(times) != len(offsets):
        return None
    cfg, tr = ctx.config, ctx.traffic
    work = ctx.registry.roofline("ivf_page").work
    sizes = ctx.ref.cell_sizes()
    b = tr["batch"]
    total = 0.0
    for off in offsets:
        q = torch.as_tensor(ctx.pool[off:off + b], device=ctx.device)
        probes = ctx.ref.probes(q, tr["nprobe"])
        probed_rows = int(sizes[probes].sum())
        union_rows = int(sizes[torch.unique(probes)].sum())
        ops, nbytes = work(probed_rows, union_rows, b, cfg["dim"],
                           cfg["quantizer"]["m"], tr["k"])
        total += bound_seconds(ops, nbytes, peak)
    return 100.0 * total / sum(times)
