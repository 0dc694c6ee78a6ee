"""mdf_update_fused's share of its bound: the mean least time that each
traced call's data needs at the card's memory bandwidth (the legs that
reseed or hard-reset read less, ``costs.update_mix``) over the kernel's
mean time a launch. ``probe`` keeps each call's flags while the window is
traced: references only, so it adds no launch. It sees the calls that go
through ``ops.kernels.mdf_update_fused``; where the trace holds another
number of the kernel's launches than it saw calls, the metric reads
nothing rather than a count of other calls."""
import contextlib
import inspect

from bench_gpu import costs
from bench_gpu.reference import graphs


@contextlib.contextmanager
def probe(ctx):
    from mediastreamer2_tpu_torch.ops import kernels
    orig = kernels.mdf_update_fused
    sig = inspect.signature(orig)
    calls = ctx.probes.setdefault("mdf_update_fused", [])

    def kept(*args, **kwargs):
        a = sig.bind(*args, **kwargs).arguments
        calls.append((a["promote"], a["reseed"], a["hard_reset"]))
        return orig(*args, **kwargs)

    kept.launches = orig.launches       # the wrapper counts through the module's name
    kernels.mdf_update_fused = kept
    try:
        yield
    finally:
        kernels.mdf_update_fused = orig
        orig.launches = kept.launches


def read(ctx):
    d = ctx.trace.launches_of("mdf_update_fused_kernel")
    calls = ctx.probes.get("mdf_update_fused", [])
    if not d or len(calls) != len(d):
        return None
    P, F, ws = graphs.aec_shape(ctx.cfg)
    bound = [costs.bound_s(costs.mdf_update_fused_cost(
        ctx.legs, P, F, ws, wm_read, wm_write, upd))
        for upd, wm_read, wm_write in (costs.update_mix(*c, bf16_shadow=ws == 2) for c in calls)]
    return 100.0 * (sum(bound) / len(bound)) / (sum(d) / len(d) * 1e-6)
