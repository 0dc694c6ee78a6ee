"""Device milliseconds a tick in hand-written kernels: every kernel that
is neither cuBLAS's nor PyTorch's (``trace.kind``), the program's CUDA
kernels today and whatever kernel a later change adds."""


def read(ctx):
    us = ctx.trace.kernel_us("hand")
    return us / 1e3 / ctx.trace.ticks if us > 0 else None
