"""Host-side WAV read/write (a copy of ``mediastreamer2_tpu/io/wav.py``:
numpy and the standard library; reference: waveheader.h,
msfileplayer/msfilerec).

Only PCM16 and mu-law/A-law WAVs, which is what the reference's testers use.
"""
from __future__ import annotations

import wave
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (float32 [-1,1] mono samples [n], rate).

    Multichannel files downmix (mean of channels) — callers expecting a
    mono signal get a correct one instead of interleaved double-speed
    audio; use read_wav_multi for the per-channel view."""
    x, rate, ch = read_wav_multi(path)
    if ch > 1:
        x = x.mean(axis=1)
    else:
        x = x.reshape(-1)
    return x, rate


def read_wav_multi(path: str) -> Tuple[np.ndarray, int, int]:
    """Returns (float32 [-1,1] samples [n, ch], rate, channels)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        sw = w.getsampwidth()
        ch = w.getnchannels()
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sw == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sw}")
    # trust the actual data length, not the header's frame count (several
    # reference fixtures carry a bogus nframes field)
    frames = len(x) // ch
    return x[: frames * ch].reshape(frames, ch), rate, ch


def write_wav(path: str, x: np.ndarray, rate: int, channels: int = 1):
    pcm = np.clip(np.round(np.asarray(x, np.float32) * 32768.0), -32768, 32767
                  ).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())
