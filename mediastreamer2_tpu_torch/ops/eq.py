"""FIR equalizer designed from a frequency-gain ladder (port of
``mediastreamer2_tpu/ops/eq.py``).

The taps come from the same frequency-sampling design (numpy, at build);
each tick the FIR runs as one product of the [B, S+T-1] extended block with
a [S+T-1, S] Toeplitz matrix built from the taps, as in JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

DEFAULT_TAPS = 128


def design_fir(rate: int, gains: list, taps: int = DEFAULT_TAPS) -> np.ndarray:
    """gains: list of (freq_hz, linear_gain, width_hz). Frequency-sampling
    design with a Hann window (the contract of MS_EQUALIZER_SET_GAIN)."""
    n_fft = 1024
    freqs = np.fft.rfftfreq(n_fft, 1.0 / rate)
    H = np.ones_like(freqs)
    for f0, g, width in gains:
        w = max(width, rate / n_fft)
        H[np.abs(freqs - f0) <= w / 2] = g
    h = np.fft.irfft(H, n_fft)
    h = np.roll(h, taps // 2)[:taps]                 # linear phase
    h *= np.hanning(taps)
    return h.astype(np.float32)


def _eq_init(ctx, device):
    B = ctx.batch
    gains = ctx.params.get("gains", [])
    taps = int(ctx.params.get("taps", DEFAULT_TAPS))
    h = design_fir(ctx.in_formats[0].rate, gains, taps) if gains else \
        np.concatenate([[1.0], np.zeros(taps - 1)]).astype(np.float32)
    return {"hist": torch.zeros((B, taps - 1), dtype=torch.float32, device=device),
            "taps": torch.from_numpy(h).to(device)}


def _eq_process(state, ins, params, ctx):
    """out[n] = sum_t h[t] x_ext[n + T-1 - t], as one matrix product."""
    x = ins[0]
    B, S = x.shape
    h = state["taps"]
    T = h.shape[0]
    x_ext = torch.cat([state["hist"], x], dim=1)                 # [B, S+T-1]
    l_idx = torch.arange(S + T - 1, device=x.device)[:, None]
    n_idx = torch.arange(S, device=x.device)[None, :]
    k = (n_idx + T - 1) - l_idx                                  # tap index
    valid = (k >= 0) & (k < T)
    M = torch.where(valid, h[torch.clamp(k, 0, T - 1)], 0.0)
    out = x_ext @ M
    return {"hist": x_ext[:, -(T - 1):], "taps": h}, (out,), {}


register_filter(FilterDef(
    name="equalizer", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_eq_init, process=_eq_process,
    interfaces=("equalizer",),
))
