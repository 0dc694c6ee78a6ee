"""Device milliseconds a tick launched inside the echo canceller's update
stage (``ms2.aec/update``): ``mdf_update_fused``, or ``mdf_update`` with
the hard reset over the f32 shadow, and the error trackers' selects
(``spans``)."""
from bench_gpu import spans


def read(ctx):
    us = spans.device_us_in(ctx.trace, "ms2.aec/update")
    return us / 1e3 / ctx.trace.ticks if us else None
