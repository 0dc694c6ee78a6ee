"""The tick's least time at the card's memory bandwidth over its time in
the measured window of the traced run (window seconds over the ticks that
landed in it). The least time counts the whole graph state (the
reference's layout at this configuration) read and written once, the
tick's inputs read once and its read-back outputs written once: bytes
only, so it reads the same work whatever implements the DFTs."""
from bench_gpu import costs


def read(ctx):
    nbytes = 2 * ctx.state_bytes + ctx.io_bytes
    return 100.0 * costs.bound_s(nbytes) / ctx.tick_s
