"""Share of the ticks' own spans (``Trace.tick_spans``, their union, as
``device_idle_pct.paced`` takes them) in which the device runs nothing
while the host is inside the program's graph step (``ms2.step``): the part
of that idle the program's dispatch leaves. The rest lies outside the
step: the harness's read-back copies and event, and the start of each
tick."""
from bench_gpu import spans


def read(ctx):
    tr = ctx.trace
    steps = spans.intervals(tr, "ms2.step")
    ticks = spans.union(tr.tick_spans())
    total = sum(b - a for a, b in ticks)
    if not steps or total <= 0:
        return None
    idle = []
    for a, b in ticks:
        edge = a
        for x, y in tr.busy_intervals(a, b):
            if x > edge:
                idle.append([edge, x])
            edge = max(edge, y)
        if b > edge:
            idle.append([edge, b])
    return 100.0 * spans.overlap_us(idle, steps) / total
