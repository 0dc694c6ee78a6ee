"""Conference mixing with mix-minus, small mixers and per-leg levels (port
of ``mediastreamer2_tpu/ops/mixer.py``).

Conference members are rows of the batch. ``group_id[b]`` names the
conference of leg b; each leg hears its conference's sum minus its own
contribution, clipped to [-1, 1] like the reference's int16 clamp.

Two branches, as in JAX:

* ``uniform_group_size=k`` (the flagship's): contiguous groups of k legs,
  a reshape-sum.
* otherwise a segment sum over ``group_id``. It is written as a product
  with a one-hot [B, B] membership matrix, which is deterministic on CUDA
  (an ``index_add_`` there uses atomics and changes its summation order
  from run to run). Its cost is O(B^2 * S); it is not on the flagship path.

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


def _conf_process(state, ins, params, ctx):
    x = ins[0]                                        # [B, S]
    B, S = x.shape
    contrib = torch.where(params["active"][:, None], x * params["gain"][:, None], 0.0)
    k = int(ctx.params.get("uniform_group_size", 0))
    if k > 0 and B % k == 0:
        sums_g = contrib.reshape(B // k, k, S).sum(dim=1)
        mix = torch.repeat_interleave(sums_g, k, dim=0)
    else:
        gid = params["group_id"].long()
        onehot = (gid[None, :] == torch.arange(B, device=x.device)[:, None]
                  ).to(torch.float32)                 # [segment, leg]
        sums = onehot @ contrib
        mix = sums[gid]
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
