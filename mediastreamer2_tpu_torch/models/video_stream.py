"""VideoStreamBatch -- session-level video call builder (port of
``mediastreamer2_tpu/models/video_stream.py``).

Reference: src/voip/videostream.c (send: source->pixconv->tee->sizeconv->
encoder->rtpsend :1559-1577; recv: rtprecv->decoder->tee2->display
:1766-1804; preview/snapshot branches, camera hot-swap :2046-2060).

The split:
* device graph (PyTorch ops on the card, ``ops/video.py``): camera
  source (mire / static image / ext frames) -> pix/size conversion -> ext
  boundary (and the mirror on receive: ext frames -> size/pix conversion
  -> display sink / analyse).
* host: frame codec (passthrough "dummy" codec like the reference's
  MSDummyEnc for server paths, or a host library codec when present) +
  RTP fragmentation/reassembly (MTU-sized chunks, marker bit = end of
  frame — the RFC-payload role of vp8rtpfmt/h26x packers).

One frame per tick per leg (100 fps ceiling at the 10 ms tick); the host
feeds/repeats frames at camera cadence like MSVideoSource does.

``device=None`` runs on ``cuda`` and raises without a card
(``core/ticker.resolve_device``); tests pass ``"cpu"``. Frames cross the
host boundary as uint8 through the ticker's ``step_fn`` hook and its
pinned slots. A codec whose host library is missing raises
``RuntimeError`` naming it (libvpx, libavcodec, libaom); nothing falls
back to the dummy codec. ``snapshot`` needs PIL and raises naming it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.block import Format
from mediastreamer2_tpu_torch.core.graph import GraphBuilder
from mediastreamer2_tpu_torch.core.ticker import Ticker, resolve_device
from mediastreamer2_tpu_torch.net.rtp import RtpSession, Transport
from mediastreamer2_tpu_torch.models.qos import IFrameRequestLimiter, VideoStarter

VIDEO_PT = 97


def _rx_is_keyframe(codec_name, frame: bytes):
    """Best-effort bitstream sniff: is this assembled access unit a
    keyframe?  True/False when the codec's syntax is known (VP8 frame tag
    bit 0, RFC 6386 §9.1; H.264 IDR/SPS NALs; H.265 IRAP NALs), None for
    codecs we don't sniff (caller treats decode success as recovery)."""
    if not frame:
        return None
    if codec_name == "vp8":
        return (frame[0] & 0x01) == 0
    if codec_name == "h264":
        i, n = 0, len(frame)
        while i + 4 < n:
            j = frame.find(b"\x00\x00\x01", i)
            if j < 0 or j + 3 >= n:
                break
            t = frame[j + 3] & 0x1F
            if t in (5, 7):                  # IDR slice / SPS in-band
                return True
            i = j + 3
        return False
    if codec_name == "h265":
        i, n = 0, len(frame)
        while i + 4 < n:
            j = frame.find(b"\x00\x00\x01", i)
            if j < 0 or j + 3 >= n:
                break
            t = (frame[j + 3] >> 1) & 0x3F
            if 16 <= t <= 21 or t == 33:     # IRAP / SPS
                return True
            i = j + 3
        return False
    return None


class FrameCodec:
    """Host frame codec interface (cf. MSFilterVideoEncoder/Decoder
    interface).  encode(frame_bytes)->bytes; decode inverse.  The default
    passthrough matches the reference's MSDummyEnc/Dec (dummy_codec.c)."""

    name = "dummy"
    def encode(self, frame: bytes, keyframe: bool) -> bytes:
        return frame

    def decode(self, data: bytes) -> Optional[bytes]:
        return data


def fragment_frame(data: bytes, mtu: int) -> List[bytes]:
    """Split an encoded frame into MTU payloads; last gets the marker."""
    chunk = mtu - 16
    return [data[i:i + chunk] for i in range(0, max(len(data), 1), chunk)]


class H264FrameCodec(FrameCodec):
    """H.264 via libavcodec/libx264 (ops/h264.py), Annex-B at the frame
    boundary. Parity: h26x-encoder-filter.cpp / h26x-decoder-filter.cpp."""

    name = "h264"

    def __init__(self, width: int, height: int, bitrate_bps: int = 500_000,
                 fps: int = 25):
        from mediastreamer2_tpu_torch.ops.h264 import H264Encoder, H264Decoder
        self.enc = H264Encoder(width, height, bitrate_bps, int(fps))
        self.dec = H264Decoder()

    def encode(self, frame: bytes, keyframe: bool) -> bytes:
        return self.enc.encode(frame, keyframe=keyframe)

    def decode(self, data: bytes) -> Optional[bytes]:
        frames = self.dec.decode(data)
        return frames[-1] if frames else None


class H265FrameCodec(FrameCodec):
    """HEVC via libx265/avcodec — the reference's h26x framework covers
    both H.264 and H.265 with the same filter templates; so does this."""

    name = "h265"

    def __init__(self, width: int, height: int, bitrate_bps: int = 500_000,
                 fps: int = 25):
        from mediastreamer2_tpu_torch.ops.h264 import H265Encoder, H265Decoder
        self.enc = H265Encoder(width, height, bitrate_bps, int(fps))
        self.dec = H265Decoder()

    def encode(self, frame: bytes, keyframe: bool) -> bytes:
        return self.enc.encode(frame, keyframe=keyframe)

    def decode(self, data: bytes) -> Optional[bytes]:
        frames = self.dec.decode(data)
        return frames[-1] if frames else None


class Av1FrameCodec(FrameCodec):
    """AV1 via libaom/dav1d (ops/av1.py); frames cross as temporal units.
    Parity: src/videofilters/av1/encoder+decoder filters."""

    name = "av1"

    def __init__(self, width: int, height: int, bitrate_bps: int = 500_000,
                 fps: int = 25):
        from mediastreamer2_tpu_torch.ops.av1 import Av1Encoder, Av1Decoder
        self.w, self.h = width, height
        self.enc = Av1Encoder(width, height, bitrate_bps, int(fps))
        self.dec = Av1Decoder()
        self.last_was_key = False

    def encode(self, frame: bytes, keyframe: bool) -> bytes:
        a = np.frombuffer(frame, np.uint8).reshape(self.h * 3 // 2, self.w)
        y = a[: self.h]
        uv = a[self.h:].reshape(self.h // 2, 2, self.w // 2)
        data, is_key = self.enc.encode_planes(y, uv[:, 0], uv[:, 1],
                                              force_keyframe=keyframe)
        self.last_was_key = is_key
        return data

    def decode(self, data: bytes) -> Optional[bytes]:
        out = self.dec.decode(data)
        if out is None:
            return None
        y, u, v = out
        uv = np.stack([u, v], axis=1).reshape(self.h // 2, self.w)
        return np.concatenate([y, uv], axis=0).tobytes()


class Av1Packetizer:
    """AV1 RTP payloads (net/av1_rtp.py): OBU elements with Z/Y
    fragmentation; a temporal unit closes on the marker bit."""

    def __init__(self, mtu: int):
        from mediastreamer2_tpu_torch.net.av1_rtp import Depacketizer
        self.mtu = mtu
        self._dep = Depacketizer()
        self.completed: List[bytes] = []
        self._last_seq = None
        self._gap = False
        self.dropped_incomplete = 0

    def pack(self, tu: bytes) -> List[bytes]:
        from mediastreamer2_tpu_torch.net import av1_rtp
        return av1_rtp.packetize(tu, self.mtu) if tu else []

    def push(self, pkt):
        if self._last_seq is not None and \
                ((pkt.seq - self._last_seq) & 0xFFFF) != 1:
            self._gap = True
        self._last_seq = pkt.seq
        self._dep.push(pkt.payload)
        if pkt.marker:
            tu = self._dep.pop_tu()
            if self._gap or tu is None:
                self.dropped_incomplete += 1
            else:
                self.completed.append(tu)
            self._gap = False

    def pop(self) -> Optional[bytes]:
        return self.completed.pop(0) if self.completed else None


class GenericPacketizer:
    """Timestamp fragmentation + marker reassembly (MSDummyEnc-style
    payloads; the generic half of vp8rtpfmt/h26x packers).

    For MPEG-4 visual this is exactly RFC 3016 §3.3 on the wire: MP4V-ES
    payloads are raw VOP fragments with NO extra header and the marker on
    the VOP's last packet — so `codec="mpeg4"` legs are wire-true."""

    def __init__(self, mtu: int):
        self.mtu = mtu
        self.asm = FrameAssembler()

    def pack(self, data: bytes) -> List[bytes]:
        return fragment_frame(data, self.mtu)

    def push(self, pkt):
        self.asm.push(pkt)

    def pop(self) -> Optional[bytes]:
        return self.asm.pop()

    @property
    def dropped_incomplete(self):
        return self.asm.dropped_incomplete

    @property
    def seq_gaps(self):
        return self.asm.seq_gaps


class H263SessionPacketizer:
    """RFC 4629 H.263 payloads behind the session packetizer interface
    (pack / push / pop) — the legacy family's transport (videoenc.c's
    RFC payload glue)."""

    name = "h263"

    def __init__(self, mtu: int):
        from mediastreamer2_tpu_torch.net.h26x import H263Depacketizer
        self.mtu = mtu
        self._de = H263Depacketizer()

    def pack(self, frame: bytes) -> List[bytes]:
        from mediastreamer2_tpu_torch.net.h26x import h263_packetize
        return h263_packetize(frame, self.mtu)

    def push(self, pkt):
        self._de.push(pkt.payload, pkt.marker)

    def pop(self):
        return self._de.pop()

    @property
    def dropped_incomplete(self):
        return self._de.errors


class JpegSessionPacketizer:
    """RFC 2435 JPEG/RTP behind the session packetizer interface — the
    MJPEG transport (static PT 26; net/jpeg_rtp.py)."""

    name = "jpeg"

    def __init__(self, mtu: int):
        from mediastreamer2_tpu_torch.net.jpeg_rtp import JpegDepacketizer
        self.mtu = mtu
        self._de = JpegDepacketizer()

    def pack(self, frame: bytes) -> List[bytes]:
        from mediastreamer2_tpu_torch.net.jpeg_rtp import jpeg_packetize
        return jpeg_packetize(frame, self.mtu)

    def push(self, pkt):
        self._de.push(pkt.payload, pkt.marker)

    def pop(self):
        return self._de.pop()

    @property
    def dropped_incomplete(self):
        return self._de.errors


class H264Packetizer:
    """RFC 6184 payloads (single NAL / STAP-A / FU-A) with SPS/PPS store;
    an access unit closes on the marker bit; seq gaps drop the AU (the
    decoder then freezes until FIR recovery — h26x unpacker semantics)."""

    def __init__(self, mtu: int):
        from mediastreamer2_tpu_torch.net.h26x import (H264Unpacker,
                                                 ParameterSetStore)
        self.mtu = mtu
        self.unpacker = H264Unpacker()
        self.ps = ParameterSetStore()
        self._nals: List[bytes] = []
        self.completed: List[bytes] = []
        self._last_seq = None
        self._cur_ts = None
        self._gap = False
        self.dropped_incomplete = 0

    def pack(self, annexb: bytes) -> List[bytes]:
        from mediastreamer2_tpu_torch.net.h26x import packetize, split_annexb
        nals = split_annexb(annexb)
        return packetize(nals, self.mtu) if nals else []

    def push(self, pkt):
        if self._last_seq is not None and                 ((pkt.seq - self._last_seq) & 0xFFFF) != 1:
            self._gap = True
        self._last_seq = pkt.seq
        for nal in self.unpacker.push(pkt.payload):
            self.ps.process(nal)
            self._nals.append(nal)
        if pkt.marker:
            self._close_au()

    def _close_au(self):
        if self._gap or not self._nals:
            self.dropped_incomplete += 1
        else:
            from mediastreamer2_tpu_torch.net.h26x import to_annexb
            # IDR without in-band SPS/PPS: replay the stored parameter
            # sets ahead of it (ParameterSetStore role, h26x framework)
            nals = self.ps.prepend_for_idr(self._nals)
            self.completed.append(to_annexb(nals))
        self._nals = []
        self._gap = False

    def pop(self) -> Optional[bytes]:
        return self.completed.pop(0) if self.completed else None


class H265Packetizer:
    """RFC 7798 payloads (single NAL / AP / FU) with the VPS/SPS/PPS
    store; same AU-close / gap-drop semantics as the H.264 packetizer."""

    def __init__(self, mtu: int):
        from mediastreamer2_tpu_torch.net.h26x import (H265Unpacker,
                                                 H265ParameterSetStore)
        self.mtu = mtu
        self.unpacker = H265Unpacker()
        self.ps = H265ParameterSetStore()
        self._nals: List[bytes] = []
        self.completed: List[bytes] = []
        self._last_seq = None
        self._gap = False
        self.dropped_incomplete = 0

    def pack(self, annexb: bytes) -> List[bytes]:
        from mediastreamer2_tpu_torch.net.h26x import h265_packetize, split_annexb
        nals = split_annexb(annexb)
        return h265_packetize(nals, self.mtu) if nals else []

    def push(self, pkt):
        if self._last_seq is not None and \
                ((pkt.seq - self._last_seq) & 0xFFFF) != 1:
            self._gap = True
        self._last_seq = pkt.seq
        for nal in self.unpacker.push(pkt.payload):
            self.ps.process(nal)
            self._nals.append(nal)
        if pkt.marker:
            self._close_au()

    def _close_au(self):
        if self._gap or not self._nals:
            self.dropped_incomplete += 1
        else:
            from mediastreamer2_tpu_torch.net.h26x import to_annexb
            self.completed.append(to_annexb(
                self.ps.prepend_for_irap(self._nals)))
        self._nals = []
        self._gap = False

    def pop(self) -> Optional[bytes]:
        return self.completed.pop(0) if self.completed else None


class ReorderBuffer:
    """Small seq-reorder stage ahead of the packetizers: on a gap, hold
    subsequent packets up to `max_hold` pops awaiting the retransmission
    (NACK fills the hole); deliver strictly in seq order.  The oRTP
    reordering role that makes video NACK useful."""

    def __init__(self, max_hold: int = 12):
        self.max_hold = max_hold
        self._next = None
        self._held: Dict[int, object] = {}
        self._hold_age = 0

    def push(self, pkt) -> List[object]:
        out = []
        if self._next is None:
            self._next = pkt.seq
        delta = (pkt.seq - self._next) & 0xFFFF
        if delta >= 0x8000:
            return out                    # stale duplicate/too-late rtx
        self._held[pkt.seq] = pkt
        while self._next in self._held:
            out.append(self._held.pop(self._next))
            self._next = (self._next + 1) & 0xFFFF
            self._hold_age = 0
        if self._held:
            self._hold_age += 1
            if self._hold_age > self.max_hold:
                # give up on the hole: release in order, skipping it
                self._next = min(self._held,
                                 key=lambda s: (s - self._next) & 0xFFFF)
                while self._next in self._held:
                    out.append(self._held.pop(self._next))
                    self._next = (self._next + 1) & 0xFFFF
                self._hold_age = 0
        return out

    @property
    def missing_seq(self):
        """First missing seq while packets are held (NACK target)."""
        return self._next if self._held else None


class FrameAssembler:
    """Reassemble fragments by timestamp; marker bit closes the frame
    (the generic half of vp8rtpfmt/h26x unpacker behavior).

    A frame's packets are ordered by their distance back from the marker
    packet's sequence number, modulo 2^16, so a frame whose packets span
    the 16-bit wrap stays whole. The JAX package sorts the raw numbers and
    drops such a frame as incomplete: with a random initial sequence
    number, an 84-packet frame crosses the wrap in about one run of
    1,260 packets in 50 per leg."""

    def __init__(self):
        self.parts: Dict[int, list] = {}
        self.completed: List[bytes] = []
        self.dropped_incomplete = 0
        # inter-frame continuity: packets lost BETWEEN frames leave every
        # delivered AU complete (small frames are one packet each), yet the
        # decoder's reference chain is broken.  The reference's unpackers
        # detect this via seq/PictureID discontinuity and fire the PLI path
        # (src/videofilters/vp8rtpfmt.c discontinuity checks); seq_gaps is
        # the generic equivalent, consumed by VideoStreamBatch's
        # decode-error -> FIR loop.  Counts spurious under heavy reordering;
        # place a ReorderBuffer ahead when NACK/rtx is in play.
        self.seq_gaps = 0
        self._expected_seq = None

    def reset_continuity(self):
        """Restart seq-continuity tracking (the stream was re-bound to a
        new session whose seq space starts fresh — not a loss event)."""
        self._expected_seq = None

    def push(self, pkt):
        if self._expected_seq is not None:
            delta = (pkt.seq - self._expected_seq) & 0xFFFF
            if 0 < delta < 0x8000:
                self.seq_gaps += 1
        self._expected_seq = (pkt.seq + 1) & 0xFFFF
        self.parts.setdefault(pkt.timestamp, []).append((pkt.seq, pkt.payload))
        if pkt.marker:
            parts = self.parts.pop(pkt.timestamp)
            back = {(pkt.seq - seq) & 0xFFFF: payload for seq, payload in parts}
            if sorted(back) == list(range(len(parts))):
                self.completed.append(b"".join(back[k] for k in reversed(range(len(parts)))))
            else:
                self.dropped_incomplete += 1
        if len(self.parts) > 8:          # stale partial frames
            for ts in sorted(self.parts)[:-4]:
                del self.parts[ts]
                self.dropped_incomplete += 1

    def pop(self) -> Optional[bytes]:
        return self.completed.pop(0) if self.completed else None


@dataclasses.dataclass
class VideoStreamStats:
    frames_sent: int = 0
    frames_received: int = 0
    keyframes_sent: int = 0   # includes FIR/PLI-forced keyframes
    fir_sent: int = 0
    camera_fallbacks: int = 0
    bitrate_cap: int = 0      # last applied TMMBR/REMB (bps)


def u8_step(step):
    """Wrap a graph step so frames cross the ext boundary as uint8:
    ``rx_frames`` comes in as u8 and ``tx_frames`` goes out as
    ``(clip(x, 0, 1) * 255 + 0.5)`` truncated to u8, as in the JAX
    package."""

    def _u8_step(state, params, ext_in):
        ext = dict(ext_in)
        if "rx_frames" in ext:
            ext["rx_frames"] = ext["rx_frames"].to(torch.float32) / 255.0
        st, out, ev = step(state, params, ext)
        if "tx_frames" in out:
            out = dict(out)
            out["tx_frames"] = (out["tx_frames"].clamp(0.0, 1.0) * 255.0
                                + 0.5).to(torch.uint8)
        return st, out, ev
    return _u8_step


class VideoStreamBatch:
    """N video legs, one device program for the pixel path."""

    def __init__(self, factory, batch: int, fmt: Format = None,
                 out_fmt: Format = None, camera: str = "mire",
                 codec: Optional[FrameCodec] = None, mtu: int = 1400,
                 fps: float = 25.0, codec_factory=None, device=None):
        """codec_factory: callable() -> FrameCodec, one per leg (stateful
        codecs like VP8 need per-leg encoder/decoder instances)."""
        self.device = resolve_device(device)
        self.batch = batch
        self.fmt = fmt or Format(kind="yuv420", width=320, height=240, fps=fps)
        self.out_fmt = out_fmt or self.fmt
        if codec == "h264":               # convenience: full H.264 legs
            w, h = self.out_fmt.width, self.out_fmt.height
            codec_factory = lambda: H264FrameCodec(w, h, fps=fps)  # noqa: E731
            packetizer_factory = lambda: H264Packetizer(mtu)       # noqa: E731
        elif codec == "h265":             # convenience: full HEVC legs
            w, h = self.out_fmt.width, self.out_fmt.height
            codec_factory = lambda: H265FrameCodec(w, h, fps=fps)  # noqa: E731
            packetizer_factory = lambda: H265Packetizer(mtu)       # noqa: E731
        elif codec == "av1":              # convenience: full AV1 legs
            w, h = self.out_fmt.width, self.out_fmt.height
            codec_factory = lambda: Av1FrameCodec(w, h, fps=fps)   # noqa: E731
            packetizer_factory = lambda: Av1Packetizer(mtu)        # noqa: E731
        elif codec == "vp8":              # convenience: full VP8 legs
            from mediastreamer2_tpu_torch.ops.vp8 import Vp8FrameCodec
            w, h = self.out_fmt.width, self.out_fmt.height
            codec_factory = lambda: Vp8FrameCodec(w, h, fps=int(fps))  # noqa: E731
            packetizer_factory = None
        elif codec in ("h263", "h263p", "mpeg4", "mjpeg", "theora", "snow"):
            # legacy ffmpeg family (videoenc.c/videodec.c) — H.263 rides
            # RFC 4629 payloads, the others plain fragmentation
            from mediastreamer2_tpu_torch.ops.h264 import make_legacy_codec
            w, h = self.out_fmt.width, self.out_fmt.height
            Enc, Dec = make_legacy_codec(codec)
            name = codec

            class _LegacyFrameCodec(FrameCodec):
                # Theora decoders need the encoder's stream headers before
                # the first frame; ship them in-band on every keyframe
                # (RFC 5215's packed-configuration idea; parity
                # src/videofilters/theora.c config packets)
                _CFG_MAGIC = b"THcf"

                def __init__(self):
                    self.enc = Enc(w, h, 400_000, int(fps))
                    if name == "theora":
                        from mediastreamer2_tpu_torch.ops.h264 import \
                            encoder_extradata
                        self._cfg = encoder_extradata(self.enc)
                        if not self._cfg:
                            # no headers -> decoders can never open; fail
                            # HERE, not as silent black video downstream
                            raise RuntimeError(
                                "theora: encoder extradata unavailable "
                                "(AVCodecContext layout drifted?)")
                        self.dec = None          # opens on first config
                    elif name == "snow":
                        # Snow's bitstream carries no dimensions (ffmpeg
                        # experimental, videoenc.c:916-1032): the size is
                        # out-of-band (SDP fmtp in the reference), so the
                        # decoder is opened with the negotiated dims
                        self._cfg = b""
                        self.dec = Dec(dims=(w, h))
                    else:
                        self._cfg = b""
                        self.dec = Dec()

                def encode(self, frame: bytes, keyframe: bool) -> bytes:
                    data = self.enc.encode(frame, keyframe=keyframe)
                    if self._cfg and keyframe and data:
                        import struct as _st
                        return (self._CFG_MAGIC
                                + _st.pack("!I", len(self._cfg))
                                + self._cfg + data)
                    return data

                def decode(self, data: bytes):
                    if data.startswith(self._CFG_MAGIC) and len(data) > 8:
                        import struct as _st
                        n = _st.unpack("!I", data[4:8])[0]
                        if len(data) >= 8 + n:
                            if self.dec is None:
                                self.dec = Dec(extradata=data[8:8 + n])
                            data = data[8 + n:]
                    if self.dec is None:         # no config seen yet
                        return None
                    frames_ = self.dec.decode(data)
                    return frames_[-1] if frames_ else None
            _LegacyFrameCodec.name = name
            codec_factory = _LegacyFrameCodec
            if codec in ("h263", "h263p"):
                packetizer_factory = lambda: H263SessionPacketizer(mtu)  # noqa: E731
            elif codec == "mjpeg":
                packetizer_factory = lambda: JpegSessionPacketizer(mtu)  # noqa: E731
            else:
                packetizer_factory = None
        else:
            packetizer_factory = None
        if codec_factory is not None:
            self.codecs = [codec_factory() for _ in range(batch)]
        else:
            self.codecs = [codec or FrameCodec()] * batch
        self.codec = self.codecs[0]
        if packetizer_factory is None:
            packetizer_factory = lambda: GenericPacketizer(mtu)    # noqa: E731
        self.packetizers = [packetizer_factory() for _ in range(batch)]
        self.mtu = mtu
        self.fps = fps
        self.stats = [VideoStreamStats() for _ in range(batch)]
        self.fir_limiters = [IFrameRequestLimiter() for _ in range(batch)]
        self.starters = [VideoStarter() for _ in range(batch)]

        g = GraphBuilder(factory, batch=batch)
        # ---- send pixel path: camera -> sizeconv -> tx frames -------------
        if camera == "mire":
            cam = g.add("mire", "cam", fmt=self.fmt)
        else:
            cam = g.add("ext_source", "cam", fmt=self.fmt)
        sc = g.add("size_conv", "sizeconv",
                   out_w=self.out_fmt.width, out_h=self.out_fmt.height)
        g.link(cam, 0, sc, 0)
        tee = g.add("tee", "tx_tee")
        g.link(sc, 0, tee, 0)
        g.link(tee, 0, g.add("ext_sink", "tx_frames"), 0)
        g.link(tee, 1, g.add("void_sink", "preview"), 0)  # preview tap parity
        # ---- recv pixel path: rx frames -> display/analyse -----------------
        rx = g.add("ext_source", "rx_frames", fmt=self.out_fmt)
        ana = g.add("analyse_display", "display")
        g.link(rx, 0, ana, 0)
        self.graph = g.build()

        # uint8 ext boundary: pixels cross host<->device as u8 (the codec
        # path quantizes to u8 anyway), cutting frame transfer bytes 4x;
        # the conversions run on the device (the ticker's step_fn hook)
        self.ticker = Ticker(self.graph, device=self.device, name=f"video[{batch}]",
                             step_fn=u8_step(self.graph.step))
        fh, fw = self.out_fmt.height * 3 // 2, self.out_fmt.width
        wz = {"rx_frames": np.zeros((batch, fh, fw), np.uint8)}
        if camera != "mire":
            shape, dtype = self.graph.ext_inputs["cam"]
            wz["cam"] = np.zeros(shape, dtype)
        self.ticker.warmup_ext = wz
        self.ticker.set_io(pull=self._pull, push=self._push)

        self.sessions: List[Optional[RtpSession]] = [None] * batch
        self.assemblers = self.packetizers     # back-compat alias
        self._frame_shape = (self.out_fmt.height * 3 // 2, self.out_fmt.width)
        self._last_rx = np.zeros((batch,) + self._frame_shape, np.float32)
        # u8 mirror of _last_rx, maintained incrementally at decode time
        # (one leg per decoded frame) so _pull never runs a whole-batch
        # numpy conversion on the paced path — a multi-MB ufunc holds the
        # GIL for its whole duration and stalls every co-resident member
        # on a 1-core host (fleet trace: 77 ms pull spike)
        self._last_rx_u8 = np.zeros((batch,) + self._frame_shape, np.uint8)
        self._leg_f32 = np.empty(self._frame_shape, np.float32)
        self._cam_buf = None
        self._tick_per_frame = max(1, int(round(100.0 / fps)))
        self._ts = 0
        # first frame of every leg is a keyframe; FIR sets this too
        self._force_kf = [True] * batch
        self._last_dropped = [0] * batch
        self.codec_name = codec if isinstance(codec, str) else None
        # Loss-damage latch: once a leg's reference chain breaks (seq gap /
        # dropped AU / decode error) it WANTS a keyframe until one actually
        # decodes — the damage events themselves are edge-triggered, so if
        # the FIR limiter happens to be inside its window at that instant
        # the request must retry on later ticks, not vanish (reference:
        # the decoder-error callback keeps firing while errors persist and
        # ms_iframe_requests_limiter paces the resulting PLIs,
        # videostream.c decoding_error_cb + msiframerequestslimiter.c).
        self._await_kf_rx = [False] * batch
        # dead-camera watchdog (ext-camera mode)
        self._cam_frames = [None] * batch
        self._cam_last_tick = [0] * batch
        self._cam_dead = [False] * batch
        self._static_fallback = None
        self._reorder: Dict[int, ReorderBuffer] = {}
        self._nacked: Dict[int, set] = {}

    CAMERA_DEAD_TICKS = 100      # 1 s without frames => camera presumed dead

    def _now_s(self) -> float:
        """Stream-clock seconds for the FIR limiter / VideoStarter /
        frame-listener timestamps.  Must scale with the ticker's ACTUAL
        interval: under frame_tick pacing (interval 1000/fps ms) a
        hardcoded ticks*0.01 ran the clock 6.67x slow, stretching the 2 s
        FIR-limiter window to ~13 wall-seconds and starving the recovery
        FIR out of the bench's loss-recovery phase (the round-4
        video_pli_recovery_ok:false root cause)."""
        return self.ticker.stats.ticks * (self.ticker.interval_ms / 1e3)

    def enable_nack(self, leg: int, history: int = 256):
        """cf. video_stream_enable_retransmission_on_nack
        (videostream.c:725): the sender keeps a retransmission history;
        the receiver reorders across gaps and NACKs the missing seq; an
        arriving retransmission fills the hole before the AU closes."""
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        sess.enable_retransmission(history)
        self._reorder[leg] = ReorderBuffer()
        self._nacked[leg] = set()

    def iterate(self):
        """media_stream_iterate for the video stream: pump events, emit
        RTCP, and apply inbound TMMBR/REMB to the encoder (the
        MSVideoQualityController reaction, mediastream.c:983-1078 +
        msvideoqualitycontroller.c). FIR/PLI/NACK are handled on the tick
        path; bitrate caps belong on the app-thread pump."""
        n = self.ticker.event_queue.pump()
        for leg, sess in enumerate(self.sessions):
            if sess is None or sess.rtcp is None:
                continue
            sess.rtcp.maybe_emit(sess.transport)
            kept = []
            for fb in sess.rtcp.feedback_in:
                if fb.kind in ("tmmbr", "remb"):
                    codec = self.codecs[leg]
                    target = getattr(self, "_vqc", None)
                    if target is not None:
                        target.on_bandwidth_estimate(int(fb.value))
                    enc = getattr(codec, "enc", codec)
                    if hasattr(enc, "set_bitrate"):
                        enc.set_bitrate(int(fb.value))
                        self.stats[leg].bitrate_cap = int(fb.value)
                else:
                    kept.append(fb)           # FIR/PLI/NACK: tick path
            sess.rtcp.feedback_in = kept
        return n

    def attach_quality_controller(self, vqc):
        """Attach a VideoQualityController: TMMBR/REMB also drive its
        config ladder (resolution/fps choices)."""
        self._vqc = vqc

    def add_frame_listener(self, leg: int, cb):
        """Subscribe to this leg's decoded frames as (ts_ms, frame) — the
        linked-video hookup audio_stream_link_video uses for A/V call
        recording (audiostream.c:2616 ITC wiring)."""
        if not hasattr(self, "_frame_listeners"):
            self._frame_listeners = {}
        self._frame_listeners.setdefault(leg, []).append(cb)

    def remove_frame_listeners(self, leg: int):
        if hasattr(self, "_frame_listeners"):
            self._frame_listeners.pop(leg, None)

    def request_keyframe(self, leg: int):
        """cf. MS_VIDEO_ENCODER_REQ_VFU / FIR handling."""
        self._force_kf[leg] = True

    def snapshot(self, leg: int, path: str, which: str = "recv"):
        """Save the last received (or sent) frame as JPEG
        (cf. MSJpegWriter snapshot branch, videostream.c local_jpegwriter)."""
        try:
            from PIL import Image
        except ImportError:
            raise RuntimeError("snapshot needs PIL (Pillow), which is not "
                               "installed") from None
        from mediastreamer2_tpu_torch.ops.video import yuv420_to_rgb
        frame = torch.from_numpy(self._last_rx[leg:leg + 1]).to(self.device)
        rgb = yuv420_to_rgb(frame, self.out_fmt.width,
                            self.out_fmt.height)[0].cpu().numpy()
        Image.fromarray((rgb * 255).astype(np.uint8)).save(path, "JPEG")
        return path

    # -- stats getters (video_stream_get_* parity) ----------------------
    def get_sent_framerate(self, leg: int) -> float:
        """video_stream_get_sent_framerate: measured average fps."""
        t = max(self.ticker.stats.ticks, 1) * 0.01
        return self.stats[leg].frames_sent / t

    def get_received_framerate(self, leg: int) -> float:
        t = max(self.ticker.stats.ticks, 1) * 0.01
        return self.stats[leg].frames_received / t

    def get_sent_video_size(self) -> tuple:
        """video_stream_get_sent_video_size (width, height)."""
        return (self.out_fmt.width, self.out_fmt.height)

    def get_received_video_size(self, leg: int) -> tuple:
        f = self._last_rx[leg]
        if f is None:
            return (0, 0)
        a = np.asarray(f)
        return (a.shape[-1], a.shape[-2] * 2 // 3)

    def reclaim_sessions(self):
        """Detach RtpSessions for reuse by a replacement stream — the video
        half of media_stream_reclaim_sessions (codec change for video
        stream tester case)."""
        out = list(self.sessions)
        self.sessions = [None] * self.batch
        return out

    def adopt_session(self, leg: int, session):
        """Attach a reclaimed session re-pointed at this stream's payload
        type; SSRC/seq continue across the codec change."""
        session.reconfigure(VIDEO_PT, 90000)
        session.jitter_buffer = None
        if session.rtcp is None:
            session.attach_rtcp(interval_s=5.0)
        self.sessions[leg] = session
        self.starters[leg].activate(now=self._now_s())

    def set_transport(self, leg: int, transport: Transport):
        self.sessions[leg] = RtpSession(transport, payload_type=VIDEO_PT,
                                        clock_rate=90000)
        self.sessions[leg].jitter_buffer = None
        # rtcp-mux feedback channel: FIR/PLI ride the same transport
        # (cf. videostream.c AVPF FIR/PLI senders :2076-2100)
        self.sessions[leg].attach_rtcp(interval_s=5.0)
        # starter runs on the stream's virtual clock (ticks), not wall time,
        # so free-running tests and realtime behave identically
        self.starters[leg].activate(now=self._now_s())

    # -- host frame <-> bytes --------------------------------------------
    def _frame_to_bytes(self, frame: np.ndarray) -> bytes:
        if frame.dtype == np.uint8:       # u8 boundary: already quantized
            return frame.tobytes()
        return (np.clip(frame, 0, 1) * 255).astype(np.uint8).tobytes()

    def _bytes_to_frame(self, data: bytes) -> Optional[np.ndarray]:
        n = self._frame_shape[0] * self._frame_shape[1]
        if len(data) != n:
            return None
        return (np.frombuffer(data, np.uint8).astype(np.float32) / 255.0
                ).reshape(self._frame_shape)

    def feed_camera_frame(self, leg: int, frame: np.ndarray):
        """External camera push (ext-camera mode). Resets the dead-camera
        watchdog for the leg."""
        self._cam_frames[leg] = frame
        self._cam_last_tick[leg] = self.ticker.stats.ticks

    def _camera_block(self, tick: int) -> np.ndarray:
        """Dead-camera detection + static-image fallback (reference:
        videostream.c dead_camera_check -> nowebcam substitution)."""
        shape = self.graph.ext_inputs["cam"][0][1:]
        if self._cam_buf is None or self._cam_buf.shape[1:] != shape:
            self._cam_buf = np.zeros((self.batch,) + shape, np.float32)
        out = self._cam_buf               # reused per tick (see _pull note)
        for i in range(self.batch):
            if tick - self._cam_last_tick[i] > self.CAMERA_DEAD_TICKS:
                if not self._cam_dead[i]:
                    self._cam_dead[i] = True
                    self.stats[i].camera_fallbacks += 1
                out[i] = self._fallback_frame(shape)
            elif self._cam_frames[i] is not None:
                self._cam_dead[i] = False
                out[i] = self._cam_frames[i]
            else:
                out[i] = 0.0
        return out

    def _fallback_frame(self, shape):
        if self._static_fallback is None:
            # mid-grey "no webcam" card (nowebcam.c role)
            f = np.full(shape, 0.5, np.float32)
            f[: shape[0] * 2 // 3: 8] = 0.8          # stripes so it's visible
            self._static_fallback = f
        return self._static_fallback

    def _store_rx_frame(self, leg: int, f: np.ndarray) -> None:
        """Land a decoded frame: f32 master (snapshot/analyse APIs) + the
        u8 device-boundary mirror, converted per-leg HERE so the per-tick
        _pull does no whole-batch work (see _last_rx_u8 note)."""
        self._last_rx[leg] = f
        s = self._leg_f32
        np.clip(f, 0.0, 1.0, out=s)
        np.multiply(s, 255.0, out=s)
        np.add(s, 0.5, out=s)
        np.copyto(self._last_rx_u8[leg], s, casting="unsafe")

    def _pull(self, tick: int) -> Dict[str, np.ndarray]:
        # async-publish mode: _push (worker thread) owns ALL session +
        # packetizer state — polling here too would race the worker's
        # pop/send on the unlocked reorder lists
        if not getattr(self.ticker, "async_publish", False):
            for i, sess in enumerate(self.sessions):
                if sess is None:
                    continue
                sess.poll()
        # u8 at the boundary (see _u8_step); _last_rx stays f32 for the
        # snapshot/analyse APIs.  The u8 mirror is maintained per-leg at
        # decode time (_store_rx_frame), so the paced path hands over a
        # ready buffer instead of converting the whole batch every tick.
        ext = {"rx_frames": self._last_rx_u8}
        if "cam" in self.graph.ext_inputs:
            ext["cam"] = self._camera_block(tick)
        return ext

    def _push(self, tick: int, ext_out: Dict):
        if getattr(self.ticker, "async_publish", False):
            for sess in self.sessions:       # worker-owned rx drain
                if sess is not None:
                    sess.poll()
        send_now = (tick % self._tick_per_frame) == 0
        frames = np.asarray(ext_out["tx_frames"])
        if send_now:
            self._ts += 90000 // int(self.fps)
            for i, sess in enumerate(self.sessions):
                if sess is None:
                    continue
                was_kf = self._force_kf[i] or self.stats[i].frames_sent == 0
                data = self.codecs[i].encode(self._frame_to_bytes(frames[i]),
                                             keyframe=self._force_kf[i])
                self._force_kf[i] = False
                chunks = self.packetizers[i].pack(data)
                for k, c in enumerate(chunks):
                    sess.ts = self._ts
                    pkt_marker = (k == len(chunks) - 1)
                    if getattr(sess, "_fm_ext_id", None) is not None:
                        # RFC 7941: S on the first fragment, E on the last,
                        # I on keyframes (SFU keyframe indication without
                        # payload access)
                        sess.set_frame_marking(start=(k == 0),
                                               end=pkt_marker,
                                               independent=was_kf)
                    sess.send_payload(c, ts_increment=0, marker=pkt_marker)
                if chunks:
                    self.stats[i].frames_sent += 1
                    if was_kf:
                        self.stats[i].keyframes_sent += 1
        # reassembly (poll already drained into on_packet? we use manual)
        for i, sess in enumerate(self.sessions):
            if sess is None:
                continue
            frame = self.packetizers[i].pop()
            decode_failed = False
            if frame is not None:
                decoded = self.codecs[i].decode(frame)
                f = self._bytes_to_frame(decoded) if decoded else None
                if f is not None:
                    self._store_rx_frame(i, f)
                    self.stats[i].frames_received += 1
                    self.starters[i].on_frame_decoded()
                    if self._await_kf_rx[i]:
                        # recovery completes only when a KEYFRAME decodes
                        # (a concealed P-frame on a broken reference chain
                        # "decodes" but the picture is damaged); unknown
                        # bitstreams clear on any decode success
                        kf = _rx_is_keyframe(self.codec_name, frame)
                        if kf is not False:
                            self._await_kf_rx[i] = False
                    for cb in getattr(self, "_frame_listeners",
                                      {}).get(i, ()):
                        cb(int(self.ticker.stats.ticks * self.ticker.interval_ms), f)
                else:
                    # complete AU but nothing decodable (e.g. P-frames
                    # without parameter sets after loss) — the reference's
                    # decoder-error -> PLI path
                    decode_failed = True
            # inbound FIR/PLI -> force a keyframe; NACK -> retransmit.
            # Other feedback (TMMBR/REMB) stays queued for iterate() —
            # bitrate reaction is the app-thread pump's job
            if sess.rtcp is not None and sess.rtcp.feedback_in:
                fbs, sess.rtcp.feedback_in = sess.rtcp.feedback_in, []
                for fb in fbs:
                    if fb.kind in ("fir", "pli"):
                        self._force_kf[i] = True
                    elif fb.kind == "nack":
                        sess.retransmit(fb.value)
                    else:
                        sess.rtcp.feedback_in.append(fb)
            # freeze-on-error + FIR policy (cf. videostream decoder error cb
            # + msiframerequestslimiter rate limiting): request a keyframe
            # when nothing decodable arrived (starter) or an access unit
            # was lost to packet loss (decode-error PLI path)
            now_s = self._now_s()
            # damage = incomplete AUs dropped + inter-frame seq gaps (whole
            # frames lost; reference chain broken even though later AUs
            # arrive complete)
            dropped = (self.packetizers[i].dropped_incomplete
                       + getattr(self.packetizers[i], "seq_gaps", 0))
            broke = dropped > self._last_dropped[i]
            self._last_dropped[i] = dropped
            if broke or decode_failed:
                self._await_kf_rx[i] = True      # latch until a kf decodes
            if (self.starters[i].need_iframe(now=now_s)
                    or self._await_kf_rx[i]) \
                    and self.fir_limiters[i].request_allowed(now=now_s):
                self.stats[i].fir_sent += 1
                from mediastreamer2_tpu_torch.net.rtcp import Feedback
                fb = Feedback("fir", sess.ssrc, sess.recv_ssrc or 0,
                              value=self.stats[i].fir_sent & 0xFF)
                sess.transport.send(fb.pack())

    def bind_assemblers(self):
        """Wire RTP on_packet to the frame assemblers (call after
        set_transport for all legs); NACK-enabled legs go through the
        reorder buffer and emit RTCP NACKs for holes."""
        for i, sess in enumerate(self.sessions):
            if sess is None:
                continue
            # a rebind follows set_transport's fresh RtpSession (new seq
            # space): restart continuity so the jump isn't read as loss
            asm = getattr(self.packetizers[i], "asm", None)
            if asm is not None and hasattr(asm, "reset_continuity"):
                asm.reset_continuity()
            if i in self._reorder:
                def deliver(pkt, _i=i, _s=sess):
                    for p in self._reorder[_i].push(pkt):
                        self.packetizers[_i].push(p)
                    miss = self._reorder[_i].missing_seq
                    if miss is not None and miss not in self._nacked[_i]:
                        self._nacked[_i].add(miss)
                        from mediastreamer2_tpu_torch.net.rtcp import Feedback
                        fb = Feedback("nack", _s.ssrc, _s.recv_ssrc or 0,
                                      value=miss)
                        _s.transport.send(fb.pack())
                sess.on_packet = deliver
            else:
                sess.on_packet = self.packetizers[i].push

    def start(self, n_ticks: int = 10 ** 9):
        self.ticker.warm_up()
        self.ticker.start(n_ticks)

    def run(self, n_ticks: int):
        self.ticker.warm_up()
        self.ticker.run(n_ticks)

    def stop(self):
        self.ticker.stop()


class VideoBundleReceiver:
    """Multi-SSRC video receive on ONE transport — bundle recv branches.

    Parity: videostream.c:1766-1804 (bundle-mode recv branches, up to
    VIDEO_STREAM_MAX_BRANCHES) + src/videofilters/video-aggregator.c (the
    funnel feeding one decoder per contributing stream).  SSRCs are
    auto-discovered (RtpBundle on_unknown_ssrc); each discovered source
    gets its own packetizer + decoder branch; latest_frames() is the
    aggregated output (e.g. for a composite display or SFU forwarding).
    """

    MAX_BRANCHES = 10            # cf. video-aggregator.c's 10 inputs

    def __init__(self, transport: Transport, frame_shape,
                 codec_factory=None, packetizer_factory=None,
                 mtu: int = 1400):
        from mediastreamer2_tpu_torch.net.rtp import RtpBundle, RtpSession
        self.bundle = RtpBundle(transport)
        self.frame_shape = frame_shape
        self._codec_factory = codec_factory or (lambda: FrameCodec())
        self._pkt_factory = packetizer_factory or \
            (lambda: GenericPacketizer(mtu))
        self.branches: Dict[int, dict] = {}      # ssrc -> branch state
        self.dropped_branches = 0
        self.bundle.on_unknown_ssrc = self._discover

    def _discover(self, pkt):
        from mediastreamer2_tpu_torch.net.rtp import RtpSession
        if len(self.branches) >= self.MAX_BRANCHES:
            self.dropped_branches += 1
            return
        sess = RtpSession.__new__(RtpSession)   # recv-only shell
        packetizer = self._pkt_factory()
        branch = {"packetizer": packetizer,
                  "codec": self._codec_factory(),
                  "frame": None, "frames_received": 0}
        self.branches[pkt.ssrc] = branch

        class _Sink:
            def _deliver(self, p, _b=branch):
                _b["packetizer"].push(p)
        self.bundle.by_ssrc[pkt.ssrc] = _Sink()

    def poll(self):
        self.bundle.poll()
        for ssrc, b in self.branches.items():
            while True:
                data = b["packetizer"].pop()
                if data is None:
                    break
                decoded = b["codec"].decode(data)
                if decoded is not None and \
                        len(decoded) == self.frame_shape[0] * self.frame_shape[1]:
                    b["frame"] = np.frombuffer(decoded, np.uint8).reshape(
                        self.frame_shape)
                    b["frames_received"] += 1

    def latest_frames(self) -> Dict[int, np.ndarray]:
        return {ssrc: b["frame"] for ssrc, b in self.branches.items()
                if b["frame"] is not None}
