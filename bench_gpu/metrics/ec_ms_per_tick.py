"""Device milliseconds a tick launched inside the echo canceller's node
span (``ms2.node/ec``, the program's ``CompiledGraph.step``): every kernel,
copy and memset of the filter, whoever wrote it (``spans``)."""
from bench_gpu import spans


def read(ctx):
    us = spans.device_us_in(ctx.trace, "ms2.node/ec")
    return us / 1e3 / ctx.trace.ticks if us else None
