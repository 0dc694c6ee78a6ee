"""mdf_apply's share of its bound: the least time its bytes take at the
card's memory bandwidth over its mean time a launch in the traced window."""
from bench_gpu import costs
from bench_gpu.reference import graphs


def read(ctx):
    d = ctx.trace.launches_of("mdf_apply_kernel")
    if not d:
        return None
    nbytes = costs.mdf_apply_cost(ctx.legs, *graphs.aec_shape(ctx.cfg))
    return 100.0 * costs.bound_s(nbytes) / (sum(d) / len(d) * 1e-6)
