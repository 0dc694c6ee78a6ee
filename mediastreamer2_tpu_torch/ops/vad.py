"""Energy VAD + DTX/comfort-noise signalling (port of
``mediastreamer2_tpu/ops/vad.py``).

Smoothed block energy against an adaptive noise floor decides ``voice``
(state, with a 300 ms hangover); events ``silence_start``,
``voice_start``, ``noise_level``, ``silence_detected`` and
``silence_ended_ms`` surface as per-leg tensors for the host's DTX and CN
decisions.
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

HANGOVER_TICKS = 30     # keep "voice" for 300 ms after last activity


def _vad_init(ctx, device):
    B = ctx.batch
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    i = lambda: torch.zeros((B,), dtype=torch.int32, device=device)
    return {
        "floor": f(1e-6),                                 # noise floor (energy)
        "energy": f(0.0),
        "hangover": i(),
        "voice": torch.ones((B,), dtype=torch.bool, device=device),
        "sil_ticks": i(),                                 # running silence length
    }


def _vad_params(ctx, device):
    B = ctx.batch
    return {
        "enabled": torch.ones((B,), dtype=torch.bool, device=device),
        "threshold_ratio": torch.full((B,), 4.0, dtype=torch.float32, device=device),
        "silence_detection": torch.zeros((B,), dtype=torch.bool, device=device),
        "silence_duration_ticks": torch.full((B,), 100, dtype=torch.int32, device=device),
        "silence_energy": torch.full((B,), 1e-4, dtype=torch.float32, device=device),
    }


def _vad_process(state, ins, params, ctx):
    x = ins[0]
    e = (x * x).mean(dim=1)
    energy = 0.7 * state["energy"] + 0.3 * e
    # noise floor: fast down, slow up
    floor = torch.where(e < state["floor"], 0.8 * state["floor"] + 0.2 * e,
                        state["floor"] * 1.02)
    floor = torch.clamp(floor, min=1e-9)
    active = e > params["threshold_ratio"] * floor
    hangover = torch.where(active, HANGOVER_TICKS,
                           torch.clamp(state["hangover"] - 1, min=0)).to(torch.int32)
    voice = active | (hangover > 0)
    voice = torch.where(params["enabled"], voice, True)
    silence_start = state["voice"] & ~voice
    voice_start = ~state["voice"] & voice
    # silence-duration measurement (raw energy gate, no hangover)
    quiet = e <= params["silence_energy"]
    sil_ticks = torch.where(quiet, state["sil_ticks"] + 1, 0).to(torch.int32)
    sd_on = params["silence_detection"]
    thr_t = params["silence_duration_ticks"]
    silence_detected = sd_on & (sil_ticks == thr_t)
    ended = sd_on & ~quiet & (state["sil_ticks"] >= thr_t)
    silence_ended_ms = torch.where(ended, state["sil_ticks"] * 10, 0).to(torch.int32)
    new_state = {"floor": floor, "energy": energy, "hangover": hangover,
                 "voice": voice, "sil_ticks": sil_ticks}
    return new_state, (x,), {
        "silence_start": silence_start,
        "voice_start": voice_start,
        "noise_level": torch.where(silence_start, torch.sqrt(floor), 0.0),
        "silence_detected": silence_detected,
        "silence_ended_ms": silence_ended_ms,
    }


register_filter(FilterDef(
    name="vad_dtx", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_vad_init, runtime_params=_vad_params, process=_vad_process,
    interfaces=("vad",),
))
