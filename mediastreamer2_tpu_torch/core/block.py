"""Tick blocks and media formats (port of ``mediastreamer2_tpu/core/block.py``).

A copy, not an import: importing any submodule of ``mediastreamer2_tpu``
runs its package ``__init__``, which imports ``core.graph`` and with it
jax. The port has to run where jax is not installed.

Every graph edge carries exactly one 10 ms tick of samples for all legs at
once, shaped ``[legs, samples_per_tick * channels]`` (interleaved channels,
float32 in [-1, 1]).
"""
from __future__ import annotations

import dataclasses

import torch

# encoded audio whose tick block holds int32 codes (the JAX package's list
# leaves the G.726 kinds out, and nothing there casts a block; the port's
# ticker casts every host input to its block dtype, so they are named here)
_CODE_KINDS = ("ulaw", "alaw", "g722", "gsm", "l16", "dvi4",
               "g726_16", "g726_24", "g726_32", "g726_40")

TICK_MS = 10  # reference: src/base/msticker.c:46 TICKER_INTERVAL


def tick_samples(rate: int, tick_ms: int = TICK_MS) -> int:
    """Samples per tick per channel at ``rate`` Hz."""
    s = rate * tick_ms
    if s % 1000 != 0:
        raise ValueError(f"rate {rate} does not yield integer samples per {tick_ms} ms tick")
    return s // 1000


@dataclasses.dataclass(frozen=True)
class Format:
    """Static per-edge media format, resolved at graph-build time.

    kind: 'pcm' (float32 audio), 'ulaw'/'alaw'/'l16'/'g722'/'gsm'/'dvi4'/
          'g726_16'..'g726_40' (encoded, still fixed-rate so shapes stay
          static), 'yuv420'/'rgb' (video).
    """
    kind: str = "pcm"
    rate: int = 8000
    channels: int = 1
    # video-only
    width: int = 0
    height: int = 0
    fps: float = 0.0

    @property
    def is_audio(self) -> bool:
        return self.kind in ("pcm", "ulaw", "alaw", "l16", "g722", "gsm", "cn", "opus", "dvi4")

    @property
    def samples_per_tick(self) -> int:
        """Per-leg flattened samples in one tick block (interleaved channels)."""
        return tick_samples(self.rate) * self.channels

    def with_(self, **kw) -> "Format":
        return dataclasses.replace(self, **kw)


def block_dtype(fmt: Format) -> torch.dtype:
    """Torch dtype of a tick block: float32 PCM/video, int32 for encoded
    codes (host narrows to uint8/int16 at the RTP boundary)."""
    if fmt.kind in _CODE_KINDS:
        return torch.int32
    return torch.float32


def block_shape(batch: int, fmt: Format) -> tuple:
    """Shape of one tick block on an edge with format ``fmt``."""
    if fmt.kind in ("yuv420",):
        # planar YUV 4:2:0 packed as [legs, h*3//2, w] (Y plane then U,V half-res)
        return (batch, fmt.height * 3 // 2, fmt.width)
    if fmt.kind in ("rgb",):
        return (batch, fmt.height, fmt.width, 3)
    return (batch, fmt.samples_per_tick)
