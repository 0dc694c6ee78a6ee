"""mdf_update's (the megakernel update's) share of its bound: the least
time its bytes take at the card's memory bandwidth over its mean time a
launch in the traced window."""
from bench_gpu import costs
from bench_gpu.reference import graphs


def read(ctx):
    d = ctx.trace.launches_of("mdf_update_kernel")
    if not d:
        return None
    P, F, _ = graphs.aec_shape(ctx.cfg)
    return 100.0 * costs.bound_s(costs.mdf_update_cost(ctx.legs, P, F)) / (sum(d) / len(d) * 1e-6)
