"""Plumbing filters: tee, void source/sink, join, delay line (port of
``mediastreamer2_tpu/ops/misc.py``).

In dataflow form a tee is fan-out and a void sink is dead code; they exist
so the session builders keep the reference's graph shapes. The delay
line's ring is updated in place (``index_copy_``), and its write position
stays on the device.
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.block import Format, block_shape
from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

TEE_OUTPUTS = 8

register_filter(FilterDef(
    name="tee", ninputs=1, noutputs=TEE_OUTPUTS,
    out_formats=lambda ctx: (ctx.in_formats[0],) * TEE_OUTPUTS,
    process=lambda state, ins, params, ctx: (state, (ins[0],) * TEE_OUTPUTS, {}),
))

register_filter(FilterDef(
    name="void_sink", ninputs=1, noutputs=0,
    out_formats=lambda ctx: (),
    process=lambda state, ins, params, ctx: (state, (), {}),
))


def _void_source_params(ctx, device):
    """The silent block, made once on the graph's device (a param, not
    state: the JAX package's void source has no state to save)."""
    return {"zeros": torch.zeros(block_shape(ctx.batch, ctx.params.get("fmt", Format())),
                                 dtype=torch.float32, device=device)}


register_filter(FilterDef(
    name="void_source", ninputs=0, noutputs=1,
    out_formats=lambda ctx: (ctx.params.get("fmt", Format()),),
    runtime_params=_void_source_params,
    process=lambda state, ins, params, ctx: (state, (params["zeros"],), {}),
))

# MSJoin semantics: pass input 0, drop input 1 (used to serialize graphs)
register_filter(FilterDef(
    name="join", ninputs=2, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    process=lambda state, ins, params, ctx: (state, (ins[0],), {}),
))


# ------------------------------------------------------------- delay line
def _delay_init(ctx, device):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    max_ticks = int(ctx.params.get("max_delay_ms", 200)) // 10
    return {"ring": torch.zeros((B, max_ticks + 1, S), dtype=torch.float32, device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


def _delay_params(ctx, device):
    return {"delay_ticks": torch.zeros((ctx.batch,), dtype=torch.int32, device=device)}


def _delay_process(state, ins, params, ctx):
    """Per-leg bulk delay in whole ticks: each leg reads ``delay_ticks``
    behind the write cursor; 0 passes through. Updates the ring in place."""
    x = ins[0]
    ring, pos = state["ring"], state["pos"]
    D = ring.shape[1]
    ring.index_copy_(1, pos.reshape(1).long(), x[:, None, :])
    read_idx = torch.remainder(pos - params["delay_ticks"], D).long()      # [B]
    out = torch.gather(ring, 1, read_idx[:, None, None].expand(-1, 1, ring.shape[2]))[:, 0]
    return {"ring": ring, "pos": torch.remainder(pos + 1, D).to(torch.int32)}, (out,), {}


register_filter(FilterDef(
    name="delay_line", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_delay_init, runtime_params=_delay_params, process=_delay_process,
))
