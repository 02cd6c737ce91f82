"""qps: every query answered in the window over the window's whole time."""


def read(ctx):
    if ctx.window.seconds <= 0:
        return None
    return ctx.window.queries / ctx.window.seconds
