"""PulseAudio capture/playback sound card, gated (a copy of
``mediastreamer2_tpu/core/pulse.py``: numpy and ctypes).

Reference: src/audiofilters/pulseaudio.c (855 LoC — MSPulseRead/Write at
:704, :829) on the PulseAudio async API.  Here the *simple* API
(libpulse-simple) carries the same role with a fraction of the surface:
pa_simple_new/read/write are synchronous calls over an ABI-stable
3-field pa_sample_spec, so no struct probing is needed.

dlopen-gated like the ALSA card: on headless images, without
libpulse-simple, the detector registers nothing and ``pulse_available()``
is False, matching a reference build without ENABLE_PULSEAUDIO.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

from mediastreamer2_tpu_torch.core.devices import (SndCard, SndCardManager,
                                             CAP_CAPTURE, CAP_PLAYBACK)

_pas = None
try:
    _p = ctypes.util.find_library("pulse-simple")
    if _p:
        _pas = ctypes.CDLL(_p)
        _pas.pa_simple_new.restype = ctypes.c_void_p
        _pas.pa_simple_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_size_t,
                                        ctypes.POINTER(ctypes.c_int)]
        _pas.pa_simple_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_size_t,
                                         ctypes.POINTER(ctypes.c_int)]
except OSError:                                    # pragma: no cover
    _pas = None

PA_SAMPLE_S16LE = 3
PA_STREAM_PLAYBACK = 1
PA_STREAM_RECORD = 2


class _PaSampleSpec(ctypes.Structure):
    _fields_ = [("format", ctypes.c_int), ("rate", ctypes.c_uint32),
                ("channels", ctypes.c_uint8)]


def pulse_available() -> bool:
    return _pas is not None


class PulseSndCard(SndCard):
    """One PulseAudio source/sink pair as a duplex SndCard
    (MSPulseRead/Write roles).  Leg 0 carries the physical device."""

    def __init__(self, rate: int = 8000, app_name: str = "mediastreamer2_tpu"):
        super().__init__(name="pulse:default", driver="pulse",
                         capabilities=CAP_CAPTURE | CAP_PLAYBACK, rate=rate)
        if _pas is None:
            raise RuntimeError("libpulse-simple not available")
        self.rate = rate
        self.samples_per_tick = rate // 100
        ss = _PaSampleSpec(PA_SAMPLE_S16LE, rate, 1)
        err = ctypes.c_int(0)
        name = app_name.encode()
        self._rec = _pas.pa_simple_new(None, name, PA_STREAM_RECORD, None,
                                       b"capture", ctypes.byref(ss), None,
                                       None, ctypes.byref(err))
        if not self._rec:
            raise RuntimeError(f"pa_simple_new(record): {err.value}")
        self._play = _pas.pa_simple_new(None, name, PA_STREAM_PLAYBACK, None,
                                        b"playback", ctypes.byref(ss), None,
                                        None, ctypes.byref(err))
        if not self._play:
            _pas.pa_simple_free(ctypes.c_void_p(self._rec))
            raise RuntimeError(f"pa_simple_new(playback): {err.value}")
        self.captured_samples = 0     # cumulative, for TickerSynchronizer
        self.played_samples = 0

    def _pull_raw(self, tick: int, batch: int) -> np.ndarray:
        out = np.zeros((batch, self.samples_per_tick), np.float32)
        buf = (ctypes.c_int16 * self.samples_per_tick)()
        err = ctypes.c_int(0)
        r = _pas.pa_simple_read(ctypes.c_void_p(self._rec), buf,
                                ctypes.sizeof(buf), ctypes.byref(err))
        if r == 0:
            self.captured_samples += self.samples_per_tick
            pcm = np.frombuffer(buf, np.int16)
            out[0] = pcm.astype(np.float32) / 32768.0
        return out

    def _push_raw(self, tick: int, block: np.ndarray):
        pcm = np.clip(block[0] * 32768.0, -32768, 32767).astype(np.int16)
        err = ctypes.c_int(0)
        r = _pas.pa_simple_write(ctypes.c_void_p(self._play),
                                 pcm.ctypes.data_as(ctypes.c_void_p),
                                 pcm.nbytes, ctypes.byref(err))
        if r == 0:
            self.played_samples += len(pcm)

    def close(self):
        for h in (getattr(self, "_rec", None), getattr(self, "_play", None)):
            if h:
                _pas.pa_simple_free(ctypes.c_void_p(h))


def detect_pulse_cards(mgr: SndCardManager):
    """Card detector (pulseaudio.c's MSSndCardDesc.detect role): registers
    the default source/sink pair when a PulseAudio daemon answers."""
    if _pas is None:
        return
    try:
        mgr.add_card(PulseSndCard())
    except RuntimeError:
        pass
