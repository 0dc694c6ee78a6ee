"""Gain / RMS metering / AGC / noise gate / DC removal (port of
``mediastreamer2_tpu/ops/volume.py``).

Gain decisions use the previous tick's smoothed energy; the control math
(AGC target, noise gate, echo-limiter duck, mute, asymmetric smoothing) is
plain PyTorch on [B] vectors. The sample pass -- DC removal, linear gain
ramp across the block, clip and metering -- is one launch of
``kernels.fused_volume``.
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter
from mediastreamer2_tpu_torch.ops import kernels

EN_EWMA = 0.3          # block-energy smoothing
AGC_SPEED_UP = 0.12    # gain decrease speed (attack, fast)
AGC_SPEED_DOWN = 0.02  # gain increase speed (release, slow)
MIN_GAIN = 0.01
MAX_GAIN = 30.0


def _vol_init(ctx, device):
    B = ctx.batch
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    return {
        "energy": f(0.0),        # smoothed RMS^2
        "gain": f(1.0),          # current applied gain
        "dc": f(0.0),            # DC estimate
        "level_db": f(-120.0),
    }


def _vol_params(ctx, device):
    B = ctx.batch
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    off = lambda: torch.zeros((B,), dtype=torch.bool, device=device)
    return {
        "static_gain": f(1.0),
        "agc_enabled": off(),
        "agc_target": f(0.05),          # target RMS (linear)
        "ng_enabled": off(),
        "ng_threshold": f(0.003),       # linear RMS threshold
        "ng_floorgain": f(0.0),
        "dc_removal": off(),
        # echo limiter: duck send gain when peer (speaker) is active
        "ea_enabled": off(),
        "ea_threshold": f(0.01),
        "ea_gain": f(0.02),
        "peer_energy": f(0.0),
        "mute": off(),
    }


def _vol_process(state, ins, params, ctx):
    x = ins[0]
    energy_prev = state["energy"]
    rms = torch.sqrt(energy_prev)
    level_db = 10.0 * torch.log10(energy_prev + 1e-12)

    # AGC: drive rms * gain toward target
    tgt = torch.clamp(params["agc_target"] / (rms + 1e-9), MIN_GAIN, MAX_GAIN)
    agc_gain = torch.where(params["agc_enabled"], tgt, 1.0)
    gate = torch.where(params["ng_enabled"] & (rms < params["ng_threshold"]),
                       params["ng_floorgain"], 1.0)
    duck = torch.where(params["ea_enabled"]
                       & (params["peer_energy"] > params["ea_threshold"] ** 2),
                       params["ea_gain"], 1.0)

    target_gain = params["static_gain"] * agc_gain * gate * duck
    target_gain = torch.where(params["mute"], 0.0, target_gain)
    # asymmetric smoothing: fast to reduce, slow to raise (anti-pump)
    speed = torch.where(target_gain < state["gain"], AGC_SPEED_UP, AGC_SPEED_DOWN)
    new_gain = state["gain"] + speed * (target_gain - state["gain"])

    dc_en = params["dc_removal"].to(torch.float32)
    out, e_block, mean = kernels.fused_volume(x, state["gain"], new_gain,
                                              state["dc"], dc_en)
    dc = 0.9 * state["dc"] + 0.1 * mean
    energy = (1 - EN_EWMA) * energy_prev + EN_EWMA * e_block

    new_state = {"energy": energy, "gain": new_gain, "dc": dc, "level_db": level_db}
    return new_state, (out,), {}


register_filter(FilterDef(
    name="volume", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_vol_init, runtime_params=_vol_params, process=_vol_process,
    interfaces=("volume",),
))
