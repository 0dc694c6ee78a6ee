"""AAC codec (host) + RFC 3640 mpeg4-generic payload format (a copy of
``mediastreamer2_tpu/ops/aac.py``: numpy and ctypes, no torch).

Reference: src/audiofilters/aac-eld.c (Apple AudioToolbox AAC-ELD) and
aac-eld-android.cpp (MediaCodec).  Both are platform-HW wrappers around an
AAC implementation the reference does not ship; this build wraps libavcodec's
native ``aac`` codec the same way (AAC-LC profile — the ELD-specific encoder
only exists in libfdk-aac, which is gated exactly like a reference build on a
platform without AudioToolbox).  The RTP payload format is the one the
reference uses: RFC 3640 aac-hbr with a 2-byte AU-headers-length field and
one 2-byte AU header per access unit (aac-eld.c:30,258,307).

ABI strategy mirrors ops/h264.py: AVCodecContext audio-field offsets are
located by AVOption sentinels ("ar" anchor confirmed by "ac" at +4), AVFrame
uses the long-stable avutil-57 head layout, and ``aac_available()`` returns
True only after an import-time encode->decode roundtrip passes.

Where libavcodec is missing (or its layout cannot be confirmed),
``aac_available()`` is False and the encoder, the decoder and
``AacStreamCodec`` raise ``RuntimeError`` naming libavcodec.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from mediastreamer2_tpu_torch.ops.h264 import _av, _avu, _r32, _rptr, _w32  # the probed avcodec layer

AV_SAMPLE_FMT_FLTP = 8
_FR_NB_SAMPLES = 112           # AVFrame.nb_samples (avutil 56..58)
_FR_FORMAT = 116
_FR_CH_LAYOUT_OLD = 216        # AVFrame.channel_layout (uint64, avutil<=57)
_FR_DATA0 = 0
_PKT_DATA, _PKT_SIZE = 24, 32

AAC_FRAME_SAMPLES = 1024       # native aac encoder frame size (AAC-LC)

# MPEG-4 sampling-frequency-index table (ISO 14496-3 1.6.3.4)
_FREQ_INDEX = {96000: 0, 88200: 1, 64000: 2, 48000: 3, 44100: 4, 32000: 5,
               24000: 6, 22050: 7, 16000: 8, 12000: 9, 11025: 10, 8000: 11}

_AUD_OFF: Optional[Tuple[int, int, int, int]] = None


def _probe_audio_offsets() -> Optional[Tuple[int, int, int, int]]:
    """(sample_rate, channels, sample_fmt, frame_size) offsets in
    AVCodecContext, located via AVOption sentinels and anchor-confirmed
    (same refuse-don't-guess discipline as ops/h264.py)."""
    global _AUD_OFF
    if _AUD_OFF is not None:
        return _AUD_OFF
    if _av is None:
        return None
    codec = _av.avcodec_find_decoder_by_name(b"aac")
    if not codec:
        return None
    ctx = _av.avcodec_alloc_context3(ctypes.c_void_p(codec))
    if not ctx:
        return None
    SCAN = 4096
    _avu.av_opt_set_int(ctypes.c_void_p(ctx), b"ar", 0x5EC0FFEE, 0)
    raw = ctypes.string_at(ctx, SCAN)
    off_ar = raw.find((0x5EC0FFEE).to_bytes(4, "little"))
    if off_ar < 0:
        return None
    _avu.av_opt_set_int(ctypes.c_void_p(ctx), b"ac", 0x0DDBA11, 0)
    raw = ctypes.string_at(ctx, SCAN)
    off_ac = raw.find((0x0DDBA11).to_bytes(4, "little"))
    # layout anchor: int sample_rate; int channels; enum sample_fmt; ...
    if off_ac != off_ar + 4:
        return None                      # layout drifted: refuse
    _AUD_OFF = (off_ar, off_ac, off_ar + 8, off_ar + 12)
    return _AUD_OFF


def make_audio_specific_config(rate: int, channels: int) -> bytes:
    """AudioSpecificConfig for AAC-LC (the fmtp config= value,
    aac-eld.c:775 reads the peer's)."""
    obj_type = 2                                   # AAC-LC
    fi = _FREQ_INDEX[rate]
    v = (obj_type << 11) | (fi << 7) | (channels << 3)
    return v.to_bytes(2, "big")


def parse_audio_specific_config(cfg: bytes) -> Tuple[int, int]:
    """-> (rate, channels). Inverse of make_audio_specific_config."""
    v = int.from_bytes(cfg[:2], "big")
    fi = (v >> 7) & 0xF
    ch = (v >> 3) & 0xF
    rates = {i: r for r, i in _FREQ_INDEX.items()}
    return rates[fi], ch


def _adts_header(rate: int, channels: int, aac_len: int) -> bytes:
    """7-byte ADTS header so the decoder needs no extradata (the same
    trick the reference's magic-cookie comment wrestles with,
    aac-eld.c:608 — ADTS framing sidesteps it)."""
    fi = _FREQ_INDEX[rate]
    full = aac_len + 7
    hdr = bytearray(7)
    hdr[0] = 0xFF
    hdr[1] = 0xF1                                  # MPEG-4, no CRC
    hdr[2] = (1 << 6) | (fi << 2) | (channels >> 2)   # profile=AAC-LC(2)-1
    hdr[3] = ((channels & 3) << 6) | ((full >> 11) & 3)
    hdr[4] = (full >> 3) & 0xFF
    hdr[5] = ((full & 7) << 5) | 0x1F
    hdr[6] = 0xFC
    return bytes(hdr)


class AacEncoder:
    """libavcodec native AAC-LC encoder: float PCM -> raw access units."""

    def __init__(self, rate: int = 16000, channels: int = 1,
                 bitrate_bps: int = 32000):
        off = _probe_audio_offsets()
        if _av is None or off is None:
            raise RuntimeError("libavcodec aac unavailable")
        codec = _av.avcodec_find_encoder_by_name(b"aac")
        if not codec:
            raise RuntimeError("aac encoder missing")
        self.rate, self.channels = rate, channels
        off_ar, off_ac, off_fmt, _ = off
        ctx = _av.avcodec_alloc_context3(ctypes.c_void_p(codec))
        _avu.av_opt_set_int(ctypes.c_void_p(ctx), b"b", bitrate_bps, 0)
        _w32(ctx, off_ar, rate)
        _w32(ctx, off_ac, channels)
        _w32(ctx, off_fmt, AV_SAMPLE_FMT_FLTP)
        # ch_layout AVOption exists on 5.1+; "ac" above covers older libs
        _avu.av_opt_set(ctypes.c_void_p(ctx), b"ch_layout",
                        b"mono" if channels == 1 else b"stereo", 0)
        if _av.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(codec),
                             None) != 0:
            raise RuntimeError("avcodec_open2(aac enc) failed")
        self.ctx = ctx
        self.pkt = _av.av_packet_alloc()
        frame = _avu.av_frame_alloc()
        _w32(frame, _FR_NB_SAMPLES, AAC_FRAME_SAMPLES)
        _w32(frame, _FR_FORMAT, AV_SAMPLE_FMT_FLTP)
        # avutil<=57 compat path: get_audio_buffer derives ch_layout from
        # the legacy channel_layout mask when ch_layout is unset
        ctypes.cast(frame + _FR_CH_LAYOUT_OLD,
                    ctypes.POINTER(ctypes.c_uint64))[0] = \
            0x4 if channels == 1 else 0x3
        if _avu.av_frame_get_buffer(ctypes.c_void_p(frame), 0) != 0:
            raise RuntimeError("av_frame_get_buffer(audio) failed")
        for ch in range(channels):
            if not _rptr(frame, _FR_DATA0 + 8 * ch):
                raise RuntimeError("AVFrame audio plane missing")
        self.frame = frame

    def encode(self, pcm: np.ndarray) -> List[bytes]:
        """One 1024-sample block ([samples] mono or [samples, ch]) ->
        zero or more raw AAC access units (encoder has lookahead delay)."""
        pcm = np.asarray(pcm, np.float32)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        assert pcm.shape == (AAC_FRAME_SAMPLES, self.channels)
        _avu.av_frame_make_writable(ctypes.c_void_p(self.frame))
        for ch in range(self.channels):             # planar float
            dst = _rptr(self.frame, _FR_DATA0 + 8 * ch)
            buf = np.ascontiguousarray(pcm[:, ch])
            ctypes.memmove(dst, buf.ctypes.data, buf.nbytes)
        out: List[bytes] = []
        if _av.avcodec_send_frame(ctypes.c_void_p(self.ctx),
                                  ctypes.c_void_p(self.frame)) != 0:
            return out
        while True:
            if _av.avcodec_receive_packet(ctypes.c_void_p(self.ctx),
                                          ctypes.c_void_p(self.pkt)) != 0:
                break
            out.append(ctypes.string_at(_rptr(self.pkt, _PKT_DATA),
                                        _r32(self.pkt, _PKT_SIZE)))
            _av.av_packet_unref(ctypes.c_void_p(self.pkt))
        return out


class AacDecoder:
    """libavcodec AAC decoder; access units are ADTS-wrapped so no
    extradata plumbing is needed."""

    def __init__(self, rate: int = 16000, channels: int = 1):
        if _av is None or _probe_audio_offsets() is None:
            raise RuntimeError("libavcodec aac unavailable")
        codec = _av.avcodec_find_decoder_by_name(b"aac")
        ctx = _av.avcodec_alloc_context3(ctypes.c_void_p(codec))
        if _av.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(codec),
                             None) != 0:
            raise RuntimeError("avcodec_open2(aac dec) failed")
        self.ctx = ctx
        self.rate, self.channels = rate, channels
        self.frame = _avu.av_frame_alloc()
        self.pkt = _av.av_packet_alloc()

    def decode(self, au: bytes) -> np.ndarray:
        """One raw access unit -> float PCM [samples, channels]
        (empty array while the decoder primes)."""
        data = _adts_header(self.rate, self.channels, len(au)) + au
        if _av.av_new_packet(ctypes.c_void_p(self.pkt), len(data)) != 0:
            return np.zeros((0, self.channels), np.float32)
        ctypes.memmove(_rptr(self.pkt, _PKT_DATA), data, len(data))
        chunks = []
        if _av.avcodec_send_packet(ctypes.c_void_p(self.ctx),
                                   ctypes.c_void_p(self.pkt)) == 0:
            while True:
                if _av.avcodec_receive_frame(
                        ctypes.c_void_p(self.ctx),
                        ctypes.c_void_p(self.frame)) != 0:
                    break
                n = _r32(self.frame, _FR_NB_SAMPLES)
                fmt = _r32(self.frame, _FR_FORMAT)
                if fmt != AV_SAMPLE_FMT_FLTP or n <= 0:
                    break
                out = np.zeros((n, self.channels), np.float32)
                for ch in range(self.channels):
                    src = _rptr(self.frame, _FR_DATA0 + 8 * ch)
                    if src:
                        out[:, ch] = np.frombuffer(
                            ctypes.string_at(src, 4 * n), np.float32)
                chunks.append(out)
        _av.av_packet_unref(ctypes.c_void_p(self.pkt))
        if not chunks:
            return np.zeros((0, self.channels), np.float32)
        return np.concatenate(chunks, axis=0)


# ---------------------------------------------------------------- RFC 3640
def rfc3640_pack(aus: List[bytes], mtu: int = 1400) -> List[bytes]:
    """aac-hbr payloads: 16-bit AU-headers-length (bits), then one
    13-bit-size/3-bit-index header per AU, then the AUs.  Mirrors
    aac-eld.c:258 (which packs one AU per packet); multiple whole AUs are
    aggregated up to the MTU, oversized AUs are fragmented (RFC 3640 §3.1:
    a fragment is always the only unit in its packet, index/delta 0)."""
    payloads: List[bytes] = []
    group: List[bytes] = []

    def flush():
        if not group:
            return
        hdr = len(group) * 16
        out = hdr.to_bytes(2, "big")
        for au in group:
            out += ((len(au) << 3)).to_bytes(2, "big")
        payloads.append(out + b"".join(group))
        group.clear()

    for au in aus:
        if len(au) + 4 > mtu:                      # fragment
            flush()
            step = mtu - 4
            for pos in range(0, len(au), step):
                frag = au[pos:pos + step]
                # RFC 3640 §3.2.3.1: each fragment's AU-size field carries
                # the size of the COMPLETE access unit
                out = (16).to_bytes(2, "big") + \
                    ((len(au) << 3)).to_bytes(2, "big") + frag
                payloads.append(out)
            continue
        cur = 2 + sum(2 + len(a) for a in group)
        if cur + 2 + len(au) > mtu:
            flush()
        group.append(au)
    flush()
    return payloads


def rfc3640_unpack(payload: bytes) -> List[bytes]:
    """One RTP payload -> list of (possibly partial) AUs with their
    AU-header sizes honored; truncated input yields what fits."""
    if len(payload) < 2:
        return []
    hdr_bits = int.from_bytes(payload[:2], "big")
    n = hdr_bits // 16
    pos = 2 + 2 * n
    if n <= 0 or pos > len(payload):
        return []
    sizes = []
    for i in range(n):
        v = int.from_bytes(payload[2 + 2 * i:4 + 2 * i], "big")
        sizes.append(v >> 3)
    aus = []
    for size in sizes:
        if pos >= len(payload):
            break
        aus.append(payload[pos:pos + size])
        pos += size
    return aus


class AacRtpAssembler:
    """Reassembles RFC 3640 fragments (an AU whose header size exceeds the
    packet's remaining bytes spans consecutive packets)."""

    def __init__(self):
        self._frag = b""
        self._want = 0

    def push(self, payload: bytes) -> List[bytes]:
        done: List[bytes] = []
        if len(payload) < 4:
            return done
        hdr_bits = int.from_bytes(payload[:2], "big")
        n = hdr_bits // 16
        pos = 2 + 2 * n
        for i in range(n):
            size = int.from_bytes(payload[2 + 2 * i:4 + 2 * i], "big") >> 3
            chunk = payload[pos:pos + min(size, len(payload) - pos)]
            pos += len(chunk)
            if self._want:                          # continuing a fragment
                self._frag += chunk
                if len(self._frag) >= self._want:
                    done.append(self._frag[:self._want])
                    self._frag, self._want = b"", 0
            elif len(chunk) < size:                 # new fragment starts
                self._frag, self._want = chunk, size
            else:
                done.append(chunk)
        return done


class AacStreamCodec:
    """Session adapter: tick-sized PCM blocks <-> one-AU RFC 3640 payloads.

    AAC's access unit is 1024 samples — not a 10 ms-tick multiple at any
    VoIP rate — so this keeps MSBufferizer-style sample-granular FIFOs on
    both directions (the reference's filter does the same with its
    ms_bufferizer, aac-eld.c enc_process).  One AU per packet, like the
    reference (aac-eld.c:30)."""

    def __init__(self, rate: int = 16000, channels: int = 1,
                 bitrate_bps: int = 32000):
        self.rate, self.channels = rate, channels
        self.enc = AacEncoder(rate, channels, bitrate_bps)
        self.dec = AacDecoder(rate, channels)
        self.asm = AacRtpAssembler()
        self._tx = np.zeros((0, channels), np.float32)
        self._rx = np.zeros((0, channels), np.float32)

    def push_tx(self, pcm: np.ndarray) -> List[bytes]:
        """Tick PCM in -> zero or more ready RTP payloads (1 AU each)."""
        pcm = np.asarray(pcm, np.float32)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        self._tx = np.concatenate([self._tx, pcm], axis=0)
        payloads: List[bytes] = []
        while len(self._tx) >= AAC_FRAME_SAMPLES:
            block, self._tx = (self._tx[:AAC_FRAME_SAMPLES],
                               self._tx[AAC_FRAME_SAMPLES:])
            for au in self.enc.encode(block):
                payloads += rfc3640_pack([au])
        return payloads

    def push_rx_payload(self, payload: bytes):
        for au in self.asm.push(payload):
            pcm = self.dec.decode(au)
            if pcm.size:
                self._rx = np.concatenate([self._rx, pcm], axis=0)

    def pull_rx(self, n: int) -> Optional[np.ndarray]:
        """n samples of decoded audio, or None if not yet buffered."""
        if len(self._rx) < n:
            return None
        out, self._rx = self._rx[:n], self._rx[n:]
        return out if self.channels > 1 else out[:, 0]


_aac_ok: Optional[bool] = None


def aac_available() -> bool:
    """True only after an import-time encode->decode roundtrip passes
    (same self-check discipline as h264_available)."""
    global _aac_ok
    if _aac_ok is not None:
        return _aac_ok
    _aac_ok = False
    if _av is None or _probe_audio_offsets() is None:
        return False
    try:
        rate = 16000
        enc = AacEncoder(rate, 1)
        dec = AacDecoder(rate, 1)
        t = np.arange(AAC_FRAME_SAMPLES * 8) / rate
        sig = (0.4 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
        got = []
        for i in range(8):
            for au in enc.encode(sig[i * 1024:(i + 1) * 1024]):
                out = dec.decode(au)
                if out.size:
                    got.append(out[:, 0])
        if not got:
            return False
        y = np.concatenate(got)
        # decoded energy must resemble the input's (coarse sanity)
        _aac_ok = bool(y.size >= 2048 and
                       0.05 < float(np.sqrt(np.mean(y ** 2))) < 1.0)
    except Exception:
        _aac_ok = False
    return _aac_ok
