"""fused_volume's share of its bound: the least time its bytes take at the
card's memory bandwidth over its mean time a launch in the traced window."""
from bench_gpu import costs
from bench_gpu.reference import ops


def read(ctx):
    d = ctx.trace.launches_of("fused_volume_kernel")
    if not d:
        return None
    nbytes = costs.fused_volume_cost(ctx.legs, ops.tick_samples(ctx.cfg["rate"]))
    return 100.0 * costs.bound_s(nbytes) / (sum(d) / len(d) * 1e-6)
