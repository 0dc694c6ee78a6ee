"""Device time and idle time put down to the program's own profiler spans
(``ms2.*``, which ``mediastreamer2_tpu_torch/core/trace.py`` makes while
the profiler records), from what ``trace.Trace`` holds.

A kernel, copy or memset belongs to a span if the runtime call that
launched it (``Trace.launches``, joined by correlation id) starts inside
one of the span's host intervals. A launch's device row is the row of
``Trace.device`` that ends where ``Trace.device_end`` says its
correlation's work ends: on one stream, two rows do not end together.
Where a launch inside the span matches no row, or more than one, the join
reads nothing (None), as ``mdf_update_fused_pct`` reads nothing where its
probe and the trace disagree. A trace without the span (a program that
makes none) reads None too.
"""
from __future__ import annotations

import bisect


def union(intervals):
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def intervals(trace, name):
    """The host intervals of the spans named ``name``, as a union."""
    return union((s, s + d) for n, c, s, d in trace.host if c == "user_annotation" and n == name)


def _within(t, merged) -> bool:
    i = bisect.bisect_right(merged, [t, float("inf")]) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


def device_us_in(trace, name):
    """Device microseconds launched inside the spans named ``name`` over the
    whole trace; None where the trace has no such span or a launch inside
    it matches no device row or more than one."""
    spans = intervals(trace, name)
    if not spans:
        return None
    rows_by_end = {}
    for _, _, s, d in trace.device:
        rows_by_end.setdefault(s + d, []).append(d)
    seen, total = set(), 0.0
    for start, corr in trace.launches:
        if corr in seen or corr not in trace.device_end or not _within(start, spans):
            continue
        seen.add(corr)
        rows = rows_by_end.get(trace.device_end[corr], [])
        if len(rows) != 1:
            return None
        total += rows[0]
    return total


def overlap_us(a, b) -> float:
    """The length of the intersection of two unions of intervals."""
    total, j = 0.0, 0
    for lo, hi in a:
        while j < len(b) and b[j][1] <= lo:
            j += 1
        k = j
        while k < len(b) and b[k][0] < hi:
            total += max(0.0, min(hi, b[k][1]) - max(lo, b[k][0]))
            k += 1
    return total
