"""Share of the ticks' own spans, each from the start of its dispatch to
its landing (their union), in which no kernel, copy or memset runs on the
device (the paced cell). The wait between a tick's landing and the next
tick's due time is left out: the idle left is the device waiting on the
host inside a tick."""


def read(ctx):
    share = ctx.trace.tick_idle_share()
    return None if share is None else 100.0 * share
