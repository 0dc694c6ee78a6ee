"""Spans on the profiler's clock.

``span(name)`` marks a stretch of host code as a ``torch.profiler`` range
(``record_function``): in the profiler's Chrome trace it is a
``user_annotation`` event on the same timebase as the CUDA kernels and
copies, and the launches inside it are joined to their device work by
correlation id. Nothing else records it: the profiler's trace is the one
output.

Unless the profiler is recording, ``span`` returns one shared null
context: a span then costs one attribute read and allocates nothing.
Names are constant strings, built once by the caller (a graph builds its
node names at build time), in the form ``ms2.<layer>`` or
``ms2.<layer>/<part>``.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named ``name`` while ``torch.profiler`` records in
    this process; a shared null context otherwise."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
