"""device_idle_pct.batch: the share of the traced slice in which no
kernel and no copy runs on the card, in %."""

from benchmark.trace import idle_pct


def read(ctx):
    return idle_pct(ctx.events, ctx.slice)
