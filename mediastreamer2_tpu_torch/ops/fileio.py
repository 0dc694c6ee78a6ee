"""Device-resident file player / recorder filters (port of
``mediastreamer2_tpu/ops/fileio.py``).

The whole decoded signal lives on the device as filter state; each tick
is a batched gather (player) or a one-tick store (recorder), so the hot
loop does no host I/O.

* Player state: ``data`` [B, T], ``length`` [B], ``pos`` [B]; params
  ``playing`` and ``loop``. EOF is the per-leg event tensor ``eof``. A
  one-dimensional signal is shared by every leg as an expanded view (the
  JAX package materialises B copies).
* Recorder state: ``buf`` [B, max_ticks * S] and the tick count ``tick``;
  the tick's block is written into ``buf`` **in place** at a position
  computed on the device, so the host never reads the count. A stopped or
  full recorder writes back what the slot held.
"""
from __future__ import annotations

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter


def _player_init(ctx, device):
    sig = torch.from_numpy(np.array(ctx.params["signal"], dtype=np.float32)).to(device)
    if sig.ndim == 1:
        sig = sig.expand(ctx.batch, sig.shape[0])
    if sig.shape[0] != ctx.batch:
        raise ValueError(f"file_player signal has {sig.shape[0]} rows, batch is {ctx.batch}")
    return {
        "data": sig,
        "length": torch.full((ctx.batch,), sig.shape[1], dtype=torch.int32, device=device),
        "pos": torch.zeros((ctx.batch,), dtype=torch.int32, device=device),
    }


def _player_params(ctx, device):
    return {
        "playing": torch.ones((ctx.batch,), dtype=torch.bool, device=device),
        "loop": torch.zeros((ctx.batch,), dtype=torch.bool, device=device),
    }


def _player_process(state, ins, params, ctx):
    S = ctx.params["fmt"].samples_per_tick
    pos, length, data = state["pos"], state["length"], state["data"]
    idx = pos[:, None] + torch.arange(S, dtype=torch.int32, device=pos.device)[None, :]
    valid = idx < length[:, None]
    safe_idx = torch.where(valid, idx, 0).long()
    out = torch.gather(data, 1, safe_idx)
    out = torch.where(valid & params["playing"][:, None], out, 0.0)
    new_pos = torch.where(params["playing"], pos + S, pos)
    eof = (pos < length) & (new_pos >= length)
    new_pos = torch.where((new_pos >= length) & params["loop"], 0, new_pos).to(torch.int32)
    return {**state, "pos": new_pos}, (out,), {"eof": eof}


register_filter(FilterDef(
    name="file_player", ninputs=0, noutputs=1,
    out_formats=lambda ctx: (ctx.params["fmt"],), init=_player_init,
    runtime_params=_player_params, process=_player_process,
    interfaces=("player",),
))


# --- recorder ---------------------------------------------------------------
def _rec_init(ctx, device):
    max_ticks = int(ctx.params.get("max_ticks", 1000))
    S = ctx.in_formats[0].samples_per_tick
    return {
        "buf": torch.zeros((ctx.batch, max_ticks * S), dtype=torch.float32, device=device),
        "tick": torch.zeros((), dtype=torch.int32, device=device),
    }


def _rec_params(ctx, device):
    return {"recording": torch.ones((), dtype=torch.bool, device=device)}


def _rec_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    max_ticks = int(ctx.params.get("max_ticks", 1000))
    buf, tick = state["buf"], state["tick"]
    slots = buf.view(B, max_ticks, S)
    slot = torch.clamp(tick, max=max_ticks - 1).reshape(1).long()
    write = params["recording"] & (tick < max_ticks)
    held = torch.index_select(slots, 1, slot)[:, 0]
    slots.index_copy_(1, slot, torch.where(write, x, held)[:, None, :])
    new_tick = (tick + params["recording"].to(torch.int32)).to(torch.int32)
    return {"buf": buf, "tick": new_tick}, (), {}


register_filter(FilterDef(
    name="file_recorder", ninputs=1, noutputs=0,
    out_formats=lambda ctx: (), init=_rec_init,
    runtime_params=_rec_params, process=_rec_process,
    interfaces=("recorder",),
))


def recorder_get_audio(state_entry, n_ticks=None, tick_samples=None) -> np.ndarray:
    """Recorded PCM of a file_recorder node's state as numpy [B, samples].
    On a card the caller first waits for the stream that recorded it
    (``Ticker.sync``)."""
    buf = state_entry["buf"]
    if n_ticks is not None and tick_samples is not None:
        buf = buf[:, : n_ticks * tick_samples]
    return buf.detach().cpu().numpy()
