"""Polyphase resampler as one matrix product per tick, and the channel
adapter (port of ``mediastreamer2_tpu/ops/resample.py``).

Each tick converts a fixed number of input samples to a fixed number of
output samples with a phase pattern that repeats every tick, so the whole
conversion is a static linear map:

    out[B, N_out] = x_ext[B, H + N_in] @ R.T

with ``R`` a Kaiser-windowed sinc polyphase matrix (``resample_matrix``, a
numpy copy of the JAX package's) and ``x_ext`` the input prefixed by H
history samples carried in state. Fixed latency = ``support`` input samples.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.block import tick_samples
from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

HALF_TAPS = 16          # one-sided taps at unity ratio (speex quality ~7)
KAISER_BETA = 8.6       # ~80 dB stopband
ROLLOFF = 0.945


@functools.lru_cache(maxsize=None)
def resample_matrix(rate_in: int, rate_out: int):
    """Build (R [N_out, H+N_in], H, support) for one tick of conversion."""
    n_in = tick_samples(rate_in)
    n_out = tick_samples(rate_out)
    ratio = rate_in / rate_out                    # input samples per output sample
    stretch = max(1.0, ratio)                     # kernel stretch for downsampling
    support = HALF_TAPS * stretch                 # one-sided support, input samples
    # latency = whole number of OUTPUT samples (so converted streams stay
    # sample-aligned even for fractional ratios like 44100<->48000)
    delay_out = int(math.ceil(support / ratio))
    shift = delay_out * ratio                     # >= support, in input samples
    H = int(math.ceil(shift + support))
    fc = ROLLOFF * 0.5 / stretch                  # cutoff, cycles per input sample

    m = np.arange(H + n_in, dtype=np.float64)
    centers = (H - shift) + np.arange(n_out, dtype=np.float64) * ratio
    t = m[None, :] - centers[:, None]             # [n_out, H+n_in]
    x = t / support
    win = np.where(np.abs(x) < 1.0,
                   np.i0(KAISER_BETA * np.sqrt(np.maximum(0.0, 1 - x * x)))
                   / np.i0(KAISER_BETA), 0.0)
    core = 2 * fc * np.sinc(2 * fc * t)
    R = core * win
    R /= R.sum(axis=1, keepdims=True)             # exact DC gain of 1 per phase
    return R.astype(np.float32), H, support


@functools.lru_cache(maxsize=None)
def _matrix_t(rate_in: int, rate_out: int, device: torch.device):
    """R.T as a contiguous tensor on ``device``."""
    R, _, _ = resample_matrix(rate_in, rate_out)
    return torch.from_numpy(np.ascontiguousarray(R.T)).to(device)


def _resample_formats(ctx):
    fmt = ctx.in_formats[0]
    return (fmt.with_(rate=int(ctx.params["out_rate"])),)


def _resample_init(ctx, device):
    fmt = ctx.in_formats[0]
    _, H, _ = resample_matrix(fmt.rate, int(ctx.params["out_rate"]))
    return {"hist": torch.zeros((ctx.batch, H * fmt.channels),
                                dtype=torch.float32, device=device)}


def _resample_process(state, ins, params, ctx):
    fmt = ctx.in_formats[0]
    out_rate = int(ctx.params["out_rate"])
    _, H, _ = resample_matrix(fmt.rate, out_rate)
    x = ins[0]
    RT = _matrix_t(fmt.rate, out_rate, x.device)
    ch = fmt.channels
    B = x.shape[0]
    x_ext = torch.cat([state["hist"], x], dim=1)
    if ch == 1:
        out = x_ext @ RT
    else:
        xe = x_ext.reshape(B, -1, ch)              # de-interleave
        out = torch.einsum("mo,bmc->boc", RT, xe).reshape(B, -1)
    new_hist = x_ext[:, -H * ch:].contiguous()
    return {"hist": new_hist}, (out,), {}


register_filter(FilterDef(
    name="resample", ninputs=1, noutputs=1,
    out_formats=_resample_formats, init=_resample_init,
    process=_resample_process,
))


# --- channel adapter (reference: src/audiofilters/chanadapt.c) --------------
def _chan_formats(ctx):
    return (ctx.in_formats[0].with_(channels=int(ctx.params["out_channels"])),)


def _chan_process(state, ins, params, ctx):
    in_ch = ctx.in_formats[0].channels
    out_ch = int(ctx.params["out_channels"])
    x = ins[0]
    B = x.shape[0]
    if in_ch == out_ch:
        return state, (x,), {}
    xs = x.reshape(B, -1, in_ch)
    if out_ch == 1:
        out = xs.mean(dim=2)                       # downmix
    elif in_ch == 1:
        out = torch.repeat_interleave(xs, out_ch, dim=2).reshape(B, -1)
    else:
        out = torch.repeat_interleave(xs.mean(dim=2, keepdim=True), out_ch,
                                      dim=2).reshape(B, -1)
    return state, (out,), {}


register_filter(FilterDef(
    name="channel_adapter", ninputs=1, noutputs=1,
    out_formats=_chan_formats, process=_chan_process,
))
