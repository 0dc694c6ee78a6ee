"""Host milliseconds a tick spends in the system's call and its read-back
copies, over the measured window of the traced run (tracing off there)."""


def read(ctx):
    return ctx.dispatch_ms
