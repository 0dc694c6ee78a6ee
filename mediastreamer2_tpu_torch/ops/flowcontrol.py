"""Audio flow control: latency trimming by gentle time compression (port
of ``mediastreamer2_tpu/ops/flowcontrol.py``; the reference's
MSAudioFlowControl, src/audiofilters/flowcontrol.c:253-262).

The output size stays one tick, so dropping N samples is done by reading N
extra samples from a carried ring and linearly resampling the oversized
read back to one tick: uniform micro-time-compression, the vectorized
equivalent of "drop the least audible samples". The ring is primed with
one tick of latency, which is also the budget the filter can trim.
``drop_samples`` is a per-leg param the session layer sets from
flow-control events; at most a quarter tick is dropped per tick.

State, the JAX package's keys: ``ring`` [B, 2S] float32 (previous tick,
current tick), ``fill`` [B] int32 (samples of buffered latency). Event:
``dropped`` [B] int32.
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter


def _fc_init(ctx, device):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    return {
        # ring holds previous tick + current tick (one tick of latency budget)
        "ring": torch.zeros((B, 2 * S), dtype=torch.float32, device=device),
        "fill": torch.full((B,), S, dtype=torch.int32, device=device),
    }


def _fc_params(ctx, device):
    return {"drop_samples": torch.zeros((ctx.batch,), dtype=torch.int32, device=device)}


def _fc_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    # ring layout: [prev tick | cur tick]; read starts at (S - fill)
    ring = torch.cat([state["ring"][:, S:], x], dim=1)
    fill = state["fill"]
    # consume S + d samples, d limited by the surplus and a quarter tick
    d = torch.minimum(torch.clamp(params["drop_samples"], min=0),
                      torch.clamp(fill, max=S // 4))
    consume = (S + d).to(torch.float32)
    start = (S - fill).to(torch.float32)
    # linear-interpolated read of `consume` samples compressed into S outputs
    k = torch.arange(S, dtype=torch.float32, device=x.device)[None, :]
    pos = start[:, None] + k * (consume[:, None] / S)
    i0 = torch.clamp(pos.to(torch.int32), 0, 2 * S - 2)
    frac = pos - i0.to(torch.float32)
    i0 = i0.long()
    v0 = torch.gather(ring, 1, i0)
    v1 = torch.gather(ring, 1, i0 + 1)
    out = v0 * (1 - frac) + v1 * frac
    return {"ring": ring, "fill": (fill - d).to(torch.int32)}, (out,), {"dropped": d}


register_filter(FilterDef(
    name="flow_control", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_fc_init, runtime_params=_fc_params, process=_fc_process,
))
