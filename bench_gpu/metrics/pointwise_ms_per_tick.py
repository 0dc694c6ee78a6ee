"""Device milliseconds a tick in PyTorch's own kernels (those in its
namespaces, ``trace.kind``): the elementwise, reduction and copy kernels
between the products and the hand-written kernels."""


def read(ctx):
    us = ctx.trace.kernel_us("pytorch")
    return us / 1e3 / ctx.trace.ticks if us > 0 else None
