"""setup_s: process start to the first timed query (data and quantizer
made from the seed, the port's add or build, warm-up; in a checkout's
first run, the kernels' nvcc build)."""


def read(ctx):
    return ctx.setup_s
