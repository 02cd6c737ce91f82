"""descend_kernel_ms.batch: device milliseconds per batch of the tree
descent's `vocab_descend_kernel` launches in the traced slice, over the
slice's batches. None where no such kernel ran: a program without the
kernel, or a tree or rows that keep the float path."""

from benchmark.trace import kernel_times


def read(ctx):
    if ctx.slice is None or ctx.traced_calls == 0:
        return None
    times = kernel_times(ctx.events, *ctx.slice, "vocab_descend_kernel")
    if not times:
        return None
    return 1e3 * sum(times) / ctx.traced_calls
