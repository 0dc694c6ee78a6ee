"""Conference mixing with mix-minus, small mixers and per-leg levels (port
of ``mediastreamer2_tpu/ops/mixer.py``).

Conference members are rows of the batch. ``group_id[b]`` names the
conference of leg b; each leg hears its conference's sum minus its own
contribution, clipped to [-1, 1] like the reference's int16 clamp.

Two branches, as in JAX:

* ``uniform_group_size=k`` (the flagship's): contiguous groups of k legs,
  a reshape-sum.
* otherwise a segment sum over ``group_id``. The legs are sorted by group
  (a stable sort, once per new ``group_id`` tensor or in-place change of
  it), and ``torch.segment_reduce`` sums each group's rows in that fixed
  order, one thread per output element on CUDA: no atomics (an
  ``index_add_`` there changes its summation order from run to run),
  O(B * S) work and memory. An id outside [0, B) joins no group, as in
  ``jax.ops.segment_sum``.

``mix2``/``mix3``/``mix4`` sum their inputs with per-input gains and clip;
``audio_levels`` passes audio through and meters each leg's smoothed block
energy (the conference's active-talker and RFC 6464/6465 level source).
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter


def _conf_params(ctx, device):
    B = ctx.batch
    return {
        "group_id": torch.arange(B, dtype=torch.int32, device=device),  # everyone alone
        "gain": torch.ones((B,), dtype=torch.float32, device=device),
        "active": torch.ones((B,), dtype=torch.bool, device=device),
        "mix_minus": torch.ones((B,), dtype=torch.bool, device=device),
        "out_gain": torch.ones((B,), dtype=torch.float32, device=device),
    }


def _segments(ctx, gid):
    """(order, offsets): the legs sorted by group id, stably, and where each
    of the B possible groups starts in that order (B + 1 offsets), cached on
    ``ctx`` until ``group_id`` is replaced or changed in place (its version
    counter), so that a tick reuses them without a sort or a host sync."""
    cached = getattr(ctx, "_segments", None)
    if cached is None or cached[0] is not gid or cached[1] != gid._version:
        ids, order = torch.sort(gid, stable=True)
        offsets = torch.searchsorted(ids, torch.arange(gid.shape[0] + 1, dtype=ids.dtype,
                                                       device=gid.device))
        cached = (gid, gid._version, order, offsets)
        ctx._segments = cached
    return cached[2], cached[3]


def _conf_process(state, ins, params, ctx):
    x = ins[0]                                        # [B, S]
    B, S = x.shape
    contrib = torch.where(params["active"][:, None], x * params["gain"][:, None], 0.0)
    k = int(ctx.params.get("uniform_group_size", 0))
    if k > 0 and B % k == 0:
        sums_g = contrib.reshape(B // k, k, S).sum(dim=1)
        mix = torch.repeat_interleave(sums_g, k, dim=0)
    else:
        gid = params["group_id"]
        order, offsets = _segments(ctx, gid)
        sums = torch.segment_reduce(contrib[order], "sum", offsets=offsets, axis=0,
                                    unsafe=True)      # [B groups, S]
        mix = sums[gid.long()]
    out = torch.where(params["mix_minus"][:, None], mix - contrib, mix)
    out = torch.clamp(out * params["out_gain"][:, None], -1.0, 1.0)
    return state, (out,), {}


register_filter(FilterDef(
    name="conf_mixer", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    runtime_params=_conf_params, process=_conf_process,
    interfaces=("conference",),
))


# --- small explicit mixers (graph-local, e.g. local play, mixed recording) --
def _mk_mixN(n):
    def process(state, ins, params, ctx):
        acc = ins[0] * params["gains"][0][:, None]
        for i in range(1, n):
            acc = acc + ins[i] * params["gains"][i][:, None]
        return state, (torch.clamp(acc, -1.0, 1.0),), {}

    def rparams(ctx, device):
        return {"gains": torch.ones((n, ctx.batch), dtype=torch.float32, device=device)}

    register_filter(FilterDef(
        name=f"mix{n}", ninputs=n, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0],),
        runtime_params=rparams, process=process,
    ))


for _n in (2, 3, 4):
    _mk_mixN(_n)


# --- RFC 6464/6465-style per-member levels for speaker selection ------------
def _levels_process(state, ins, params, ctx):
    x = ins[0]
    sm = 0.7 * state["energy"] + 0.3 * (x * x).mean(dim=1)
    return {"energy": sm}, (x,), {"level": sm}


register_filter(FilterDef(
    name="audio_levels", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=lambda ctx, device: {"energy": torch.zeros((ctx.batch,), dtype=torch.float32,
                                                    device=device)},
    process=_levels_process,
))
