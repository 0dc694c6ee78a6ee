"""The exact row exchange between the shards of a leg batch: what a
cross-leg filter built for a ``LegShard`` (``core/filter.py``) calls, and
what ``parallel/sharding.gather_tree`` is built from.

Ranks exchange values, never partial sums: each writes its rows into
their global slots of a zero buffer and one ``all_reduce`` (sum) runs over
the buffer's bits as integers. Every slot has one non-zero writer, so
``x + 0 + 0 + 0`` is ``x`` bit for bit. ``all_reduce`` is the one
collective that both gloo (CUDA tensors included) and NCCL take.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist


def _as_int(t: torch.Tensor) -> torch.Tensor:
    """The bits of ``t`` as an integer tensor that gloo and NCCL both sum:
    4- and 8-byte types by view, 2-byte floats' bits and the narrow
    integers and bools widened to int32. Summing a value with zeros then
    returns its exact bits (-0.0 and NaNs included)."""
    if t.element_size() >= 4:
        return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    if t.is_floating_point():
        return t.view(torch.int16).to(torch.int32)
    return t.to(torch.int32)


def _from_int(i: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype.itemsize >= 4:
        return i.view(dtype)
    if dtype.is_floating_point:
        return i.to(torch.int16).view(dtype)
    return i.to(dtype)


def sum_exact(buf: torch.Tensor, group=None) -> torch.Tensor:
    """``all_reduce`` (sum) of ``buf`` over ``group``, exact where every
    element has at most one rank writing a non-zero value: the bits travel
    as integers, so ``x + 0 + 0 + 0`` is ``x``. Returns the result in
    ``buf``'s dtype; ``buf`` itself may be overwritten. Counted and
    host-timed in ``collective_stats``."""
    t0 = time.perf_counter()
    i = _as_int(buf).contiguous()
    dist.all_reduce(i, op=dist.ReduceOp.SUM, group=group)
    out = _from_int(i, buf.dtype)
    sum_exact.calls += 1
    sum_exact.seconds += time.perf_counter() - t0
    return out


sum_exact.calls = 0
sum_exact.seconds = 0.0


def collective_stats() -> dict:
    """Collectives run by ``sum_exact`` since the last reset, and the host
    seconds they took (for gloo the host waits for the exchange; for NCCL
    this is the enqueue)."""
    return {"calls": sum_exact.calls, "seconds": sum_exact.seconds}


def reset_collective_stats():
    sum_exact.calls, sum_exact.seconds = 0, 0.0


def exchange_rows(rows: torch.Tensor, offset: int, total: int, group=None) -> torch.Tensor:
    """Every rank's ``rows`` placed at ``[offset, offset + len(rows))`` of
    a zero ``[total, ...]`` buffer and summed over ``group`` exactly: each
    rank gets the whole buffer, bit for bit the rows each rank gave."""
    buf = torch.zeros((total,) + tuple(rows.shape[1:]), dtype=rows.dtype, device=rows.device)
    buf[offset:offset + rows.shape[0]] = rows
    return sum_exact(buf, group)
