"""ALSA capture/playback sound card -- real-microphone path for the CLI (a
copy of ``mediastreamer2_tpu/core/alsa.py``: numpy and ctypes).

Reference: src/audiofilters/alsa.c (1,197 LoC — MSAlsaRead/Write at :1043,
:1176): snd_pcm open/configure/read/write with period-based timing feeding
the ticker synchronizer.

Binding: libasound via ctypes, dlopen-probed — absent on headless server
images, in which case ``alsa_available()`` is False and
the card never registers; the framework stays fully functional on the
null/file cards.  The PCM surface used is small and ABI-stable
(snd_pcm_open/set_params/readi/writei/recover/avail/close), so no struct
offsets are involved.
"""
from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

from mediastreamer2_tpu_torch.core.devices import (SndCard, SndCardManager,
                                             CAP_CAPTURE, CAP_PLAYBACK)

_asound = None
try:
    _p = ctypes.util.find_library("asound")
    if _p:
        _asound = ctypes.CDLL(_p)
        _asound.snd_pcm_open.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int]
        _asound.snd_pcm_set_params.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
            ctypes.c_uint, ctypes.c_int, ctypes.c_uint]
        _asound.snd_pcm_readi.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_ulong]
        _asound.snd_pcm_readi.restype = ctypes.c_long
        _asound.snd_pcm_writei.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_ulong]
        _asound.snd_pcm_writei.restype = ctypes.c_long
        _asound.snd_pcm_recover.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                            ctypes.c_int]
except OSError:                                    # pragma: no cover
    _asound = None

SND_PCM_STREAM_PLAYBACK = 0
SND_PCM_STREAM_CAPTURE = 1
SND_PCM_FORMAT_S16_LE = 2
SND_PCM_ACCESS_RW_INTERLEAVED = 3
SND_PCM_NONBLOCK = 1


def alsa_available() -> bool:
    return _asound is not None


class AlsaSndCard(SndCard):
    """One ALSA device as a duplex SndCard (MSAlsaRead/Write roles).

    pull() returns the last captured tick block per leg (leg 0 carries the
    real microphone; other legs get silence — one physical device).
    push() writes leg 0's speaker block.  Cumulative sample counters feed
    TickerSynchronizer (alsa.c's snd_pcm_avail-driven clock feedback)."""

    def __init__(self, device: str = "default", rate: int = 8000,
                 latency_us: int = 40000):
        super().__init__(name=f"alsa:{device}", driver="alsa",
                         capabilities=CAP_CAPTURE | CAP_PLAYBACK, rate=rate)
        if _asound is None:
            raise RuntimeError("libasound not available")
        self.device = device.encode()
        self.rate = rate
        self.samples_per_tick = rate // 100
        self._cap = ctypes.c_void_p()
        self._play = ctypes.c_void_p()
        for handle, stream in ((self._cap, SND_PCM_STREAM_CAPTURE),
                               (self._play, SND_PCM_STREAM_PLAYBACK)):
            r = _asound.snd_pcm_open(ctypes.byref(handle), self.device,
                                     stream, SND_PCM_NONBLOCK)
            if r < 0:
                raise RuntimeError(f"snd_pcm_open({stream}): {r}")
            r = _asound.snd_pcm_set_params(
                handle, SND_PCM_FORMAT_S16_LE, SND_PCM_ACCESS_RW_INTERLEAVED,
                1, rate, 1, latency_us)
            if r < 0:
                raise RuntimeError(f"snd_pcm_set_params: {r}")
        self.captured_samples = 0     # cumulative, for TickerSynchronizer
        self.played_samples = 0

    def _pull_raw(self, tick: int, batch: int) -> np.ndarray:
        out = np.zeros((batch, self.samples_per_tick), np.float32)
        buf = (ctypes.c_int16 * self.samples_per_tick)()
        n = _asound.snd_pcm_readi(self._cap, buf, self.samples_per_tick)
        if n < 0:
            _asound.snd_pcm_recover(self._cap, int(n), 1)
            return out
        if n > 0:
            self.captured_samples += int(n)
            pcm = np.frombuffer(buf, np.int16, count=int(n))
            out[0, : int(n)] = pcm.astype(np.float32) / 32768.0
        return out

    def _push_raw(self, tick: int, block: np.ndarray):
        pcm = np.clip(block[0] * 32768.0, -32768, 32767).astype(np.int16)
        n = _asound.snd_pcm_writei(self._play, pcm.ctypes.data_as(
            ctypes.c_void_p), len(pcm))
        if n < 0:
            _asound.snd_pcm_recover(self._play, int(n), 1)
        else:
            self.played_samples += int(n)

    def close(self):
        for h in (self._cap, self._play):
            if h:
                _asound.snd_pcm_close(h)


def detect_alsa_cards(mgr: SndCardManager):
    """Card detector (registered like alsa.c's MSSndCardDesc.detect):
    registers the 'default' ALSA device when libasound is present and the
    device opens."""
    if _asound is None:
        return
    try:
        mgr.add_card(AlsaSndCard("default"))
    except RuntimeError:
        pass
