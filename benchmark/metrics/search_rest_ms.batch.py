"""search_rest_ms.batch: device milliseconds per batch of all device work
(kernels, copies, sets) other than the cell's scan kernel, over the
batches of the traced slice."""

from benchmark.trace import kernel_times, op_seconds


def read(ctx):
    if ctx.slice is None or ctx.traced_calls == 0:
        return None
    total = sum(op_seconds(ctx.events, *ctx.slice).values())
    scan = sum(kernel_times(ctx.events, *ctx.slice, ctx.scan_kernel))
    return 1e3 * (total - scan) / ctx.traced_calls
