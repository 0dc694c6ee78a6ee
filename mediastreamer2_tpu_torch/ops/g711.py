"""G.711 mu-law / A-law companding and L16, branch-free over whole
``[legs, samples]`` blocks (port of ``mediastreamer2_tpu/ops/g711.py``).

The same integer bit math as the JAX package, bit for bit: a threshold
count replaces the segment search. Everything is int32, because PyTorch on
the CPU has no uint32 add or shift; ``>>`` on int32 is arithmetic, as in
JAX.

PCM convention: float32 in [-1, 1] <-> int16 full scale. Encoded blocks are
int32 holding the 0..255 code (the host narrows to uint8 at the RTP edge).
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

_ULAW_SEG = (0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF, 0x1FFF)
_ALAW_SEG = (0x1F, 0x3F, 0x7F, 0xFF, 0x1FF, 0x3FF, 0x7FF, 0xFFF)


def _segment(mag: torch.Tensor, thresholds) -> torch.Tensor:
    """How many thresholds ``mag`` exceeds (int32)."""
    seg = torch.zeros_like(mag)
    for t in thresholds:
        seg += (mag > t).to(torch.int32)
    return seg


def float_to_pcm16(x: torch.Tensor) -> torch.Tensor:
    """float32 -> int16-range int32; rounds half to even, as ``jnp.round``."""
    return torch.clamp(torch.round(x * 32768.0), -32768, 32767).to(torch.int32)


def pcm16_to_float(p: torch.Tensor) -> torch.Tensor:
    return p.to(torch.float32) / 32768.0


def ulaw_encode(pcm: torch.Tensor) -> torch.Tensor:
    """int16-range int32 -> mu-law code (int32 in 0..255)."""
    pcm = pcm >> 2                                   # 14-bit domain
    neg = pcm < 0
    mag = torch.where(neg, -pcm, pcm)
    mag = torch.clamp(mag, max=8159) + 33            # clip + bias (BIAS>>2)
    seg = _segment(mag, _ULAW_SEG)
    uval = torch.where(seg >= 8, 0x7F, (seg << 4) | ((mag >> (seg + 1)) & 0xF))
    return torch.where(neg, uval ^ 0x7F, uval ^ 0xFF)


def ulaw_decode(u: torch.Tensor) -> torch.Tensor:
    u = (~u) & 0xFF
    t = (((u & 0xF) << 3) + 0x84) << ((u & 0x70) >> 4)
    return torch.where((u & 0x80) != 0, 0x84 - t, t - 0x84)


def alaw_encode(pcm: torch.Tensor) -> torch.Tensor:
    pcm = pcm >> 3                                   # 13-bit domain
    neg = pcm < 0
    mag = torch.where(neg, -pcm - 1, pcm)
    seg = _segment(mag, _ALAW_SEG)
    shifted = torch.where(seg < 2, (mag >> 1) & 0xF, (mag >> seg) & 0xF)
    aval = torch.where(seg >= 8, 0x7F, (seg << 4) | shifted)
    return torch.where(neg, aval ^ 0x55, aval ^ 0xD5)


def alaw_decode(a: torch.Tensor) -> torch.Tensor:
    a = a ^ 0x55
    t = (a & 0xF) << 4
    seg = (a & 0x70) >> 4
    t = torch.where(seg == 0, t + 8,
                    torch.where(seg == 1, t + 0x108,
                                (t + 0x108) << torch.clamp(seg - 1, min=0)))
    return torch.where((a & 0x80) != 0, t, -t)


def _register_codec(name, kind, encode, decode):
    register_filter(FilterDef(
        name=f"{name}_enc", ninputs=1, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0].with_(kind=kind),),
        process=lambda state, ins, params, ctx: (state, (encode(ins[0]),), {}),
        category="encoder", enc_fmt=kind, interfaces=("audio_encoder",),
    ))
    register_filter(FilterDef(
        name=f"{name}_dec", ninputs=1, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0].with_(kind="pcm"),),
        process=lambda state, ins, params, ctx: (state, (decode(ins[0]),), {}),
        category="decoder", enc_fmt=kind, interfaces=("audio_decoder",),
    ))


# PCMU and PCMA (reference ulaw.c, alaw.c), and L16 (RFC 2586, l16.c)
_register_codec("ulaw", "ulaw", lambda x: ulaw_encode(float_to_pcm16(x)),
                lambda c: pcm16_to_float(ulaw_decode(c)))
_register_codec("alaw", "alaw", lambda x: alaw_encode(float_to_pcm16(x)),
                lambda c: pcm16_to_float(alaw_decode(c)))
_register_codec("l16", "l16", float_to_pcm16, pcm16_to_float)
