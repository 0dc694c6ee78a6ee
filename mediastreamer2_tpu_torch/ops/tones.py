"""Tone synthesis (DTMF / custom tones) and DFT-projection tone detection
(port of ``mediastreamer2_tpu/ops/tones.py``).

``dtmf_gen`` adds a dual tone with a 4 ms envelope to the passing stream
for ``remaining`` samples (event ``tone_done``); ``tone_detector`` projects
a 40 ms Hann window onto a bank of 8 frequencies per leg each tick and
fires ``tone_event`` on a rising edge of the smoothed amplitude.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

# standard DTMF pairs, indexed 0-15: 123A 456B 789C *0#D
DTMF_ROWS = np.array([697.0, 770.0, 852.0, 941.0])
DTMF_COLS = np.array([1209.0, 1336.0, 1477.0, 1633.0])
DTMF_KEYS = "123A456B789C*0#D"
NUM_SCAN_FREQS = 8    # detector bank width (DTMF needs exactly 8)
DET_WINDOW_TICKS = 4  # 40 ms analysis window (typical DTMF minimum duration)


def dtmf_freqs(key: str):
    i = DTMF_KEYS.index(key.upper())
    return float(DTMF_ROWS[i // 4]), float(DTMF_COLS[i % 4])


def classify_dtmf(hits: np.ndarray) -> str | None:
    """Map a [NUM_SCAN_FREQS] hit/power row to a DTMF key."""
    hits = np.asarray(hits)
    rows, cols = hits[:4], hits[4:8]
    if rows.any() and cols.any():
        return DTMF_KEYS[int(np.argmax(rows)) * 4 + int(np.argmax(cols))]
    return None


def _gen_init(ctx, device):
    z = lambda: torch.zeros((ctx.batch,), dtype=torch.float32, device=device)
    return {"phase1": z(), "phase2": z()}


def _gen_params(ctx, device):
    B = ctx.batch
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    return {
        "f1": f(0.0),
        "f2": f(0.0),                                   # 0 => single tone
        "amplitude": f(0.5),
        "remaining": torch.zeros((B,), dtype=torch.int32, device=device),
        "silent_passthrough": torch.zeros((B,), dtype=torch.bool, device=device),
    }


def _gen_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    rate = ctx.in_formats[0].rate
    n = torch.arange(S, dtype=torch.float32, device=x.device)[None, :]
    w1 = 2 * math.pi * params["f1"][:, None] / rate
    w2 = 2 * math.pi * params["f2"][:, None] / rate
    tone = torch.sin(state["phase1"][:, None] + w1 * n)
    tone = tone + torch.where(params["f2"][:, None] > 0,
                              torch.sin(state["phase2"][:, None] + w2 * n), 0.0)
    # envelope: ramp in/out over 4 ms to avoid clicks
    ramp_len = max(1, rate * 4 // 1000)
    rem = params["remaining"][:, None].to(torch.float32)
    env_on = torch.clamp(n / ramp_len, max=1.0)
    env_off = torch.clamp((rem - n) / ramp_len, 0.0, 1.0)
    env = torch.where(n < rem, torch.minimum(env_on, env_off), 0.0)
    tone = tone * env * params["amplitude"][:, None] * 0.5
    base = torch.where(params["silent_passthrough"][:, None] & (rem > 0), 0.0, x)
    out = torch.clamp(base + tone, -1.0, 1.0)
    two_pi = 2 * math.pi
    new_state = {
        "phase1": torch.remainder(state["phase1"] + w1[:, 0] * S, two_pi),
        "phase2": torch.remainder(state["phase2"] + w2[:, 0] * S, two_pi),
    }
    finished = (params["remaining"] > 0) & (params["remaining"] <= S)
    return new_state, (out,), {"tone_done": finished}


register_filter(FilterDef(
    name="dtmf_gen", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_gen_init, runtime_params=_gen_params, process=_gen_process,
))


def _det_init(ctx, device):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    return {"power": torch.zeros((B, NUM_SCAN_FREQS), dtype=torch.float32, device=device),
            "above": torch.zeros((B, NUM_SCAN_FREQS), dtype=torch.bool, device=device),
            "hist": torch.zeros((B, (DET_WINDOW_TICKS - 1) * S), dtype=torch.float32,
                                device=device)}


def _det_params(ctx, device):
    B = ctx.batch
    freqs = torch.from_numpy(np.concatenate([DTMF_ROWS, DTMF_COLS]).astype(np.float32))
    return {
        "freqs": freqs.to(device).expand(B, NUM_SCAN_FREQS),
        "threshold": torch.full((B,), 0.05, dtype=torch.float32, device=device),
        "enabled": torch.ones((B,), dtype=torch.bool, device=device),
    }


def _det_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    rate = ctx.in_formats[0].rate
    win = torch.cat([state["hist"], x], dim=1)                   # [B, W]
    W = win.shape[1]
    n = torch.arange(W, dtype=torch.float32, device=x.device)
    hann = 0.5 - 0.5 * torch.cos(2 * math.pi * n / W)
    winx = win * hann[None, :]
    w = 2 * math.pi * params["freqs"] / rate                     # [B, F]
    ph = w[:, :, None] * n[None, None, :]                        # [B, F, W]
    re = torch.einsum("bfs,bs->bf", torch.cos(ph), winx)
    im = torch.einsum("bfs,bs->bf", torch.sin(ph), winx)
    # normalized amplitude: |DFT| / (coherent gain * W/2), Hann gain = 0.5
    amp = torch.sqrt(re * re + im * im) * (4.0 / W)
    power = 0.5 * state["power"] + 0.5 * amp
    above = power > params["threshold"][:, None]
    hit = above & ~state["above"] & params["enabled"][:, None]  # rising edge
    new_state = {"power": power, "above": above, "hist": win[:, S:]}
    return new_state, (x,), {"tone_event": hit}


register_filter(FilterDef(
    name="tone_detector", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_det_init, runtime_params=_det_params, process=_det_process,
))
