"""Realtime GC discipline for paced runs (port of
``mediastreamer2_tpu/core/rtgc.py``).

A gen-2 collection of a process holding hundreds of MB of buffers can
pause it for ~100 ms, which starves every 10 ms tick edge in its way. Paced
sections therefore run with cycle collection off and the startup heap
frozen out of scan reach, with one explicit collect at section exit.
Reference counting still frees per-tick buffers at once: only cycle
collection is deferred.
"""
from __future__ import annotations

import contextlib
import gc

_depth = 0


@contextlib.contextmanager
def paused_gc():
    """Collect now, freeze survivors, disable cycle GC; restore on exit.

    Re-entrant: nesting keeps GC off until the outermost exit."""
    global _depth
    _depth += 1
    try:
        if _depth == 1:
            gc.collect()
            gc.freeze()
            gc.disable()
        yield
    finally:
        _depth -= 1
        if _depth == 0:
            gc.enable()
            gc.unfreeze()
            gc.collect()
