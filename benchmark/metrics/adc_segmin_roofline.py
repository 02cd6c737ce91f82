"""adc_segmin_roofline: the least time the card could take for one
`adc_segmin_kernel` call at the cell's shapes (benchmark/roofline), over
the profiler's device time per launch in the traced slice, in %."""

from benchmark.roofline import bound_seconds
from benchmark.trace import kernel_times


def read(ctx):
    peak = ctx.registry.peaks().get(ctx.kind)
    if ctx.slice is None or peak is None:
        return None
    times = kernel_times(ctx.events, *ctx.slice, "adc_segmin_kernel")
    if not times:
        return None
    cfg, tr = ctx.config, ctx.traffic
    ops, nbytes = ctx.registry.roofline("adc_segmin").work(
        cfg["n"], tr["batch"], cfg["dim"], cfg["quantizer"]["m"], tr["k"])
    return 100.0 * bound_seconds(ops, nbytes, peak) * len(times) / sum(times)
