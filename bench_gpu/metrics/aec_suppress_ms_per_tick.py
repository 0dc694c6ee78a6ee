"""Device milliseconds a tick launched inside the echo canceller's
suppress stage (``ms2.aec/suppress``): the output limiter and the
residual-echo suppressor with its three DFTs (``spans``)."""
from bench_gpu import spans


def read(ctx):
    us = spans.device_us_in(ctx.trace, "ms2.aec/suppress")
    return us / 1e3 / ctx.trace.ticks if us else None
