"""Device milliseconds a tick in cuBLAS kernels: the DFT and resampler
products."""


def read(ctx):
    us = ctx.trace.kernel_us("cublas")
    return us / 1e3 / ctx.trace.ticks if us > 0 else None
