"""CUDA kernels launched a tick: every kernel in the traced window over
the ticks traced."""


def read(ctx):
    n = len(ctx.trace.kernels())
    return n / ctx.trace.ticks if n and ctx.trace.ticks else None
