"""MSMediaPlayer / MSMediaRecorder equivalents — standalone file play and
record sessions on a private ticker (port of
``mediastreamer2_tpu/models/media_player.py``).

Reference: src/voip/msmediaplayer.c:69-91 (open/sniff -> decoders -> sinks
graph, seek/pause via player methods, EOF notify) and msmediarecorder.c.
Containers: WAV, SMFF and Matroska, demuxed and decoded on the host; the
decoded signal is uploaded once into the ``file_player`` filter's state
and each tick is a gather on the device (``ops/fileio.py``).

* ``MediaPlayer``: open (sniffed by extension), ``set_output``, ``start``,
  ``pause``, ``set_loop``, ``seek_ms``, ``get_position_ms``, ``close`` and
  ``on_eof`` (run by ``ticker.event_queue.pump()``). Audio tracks: Opus,
  PCM (``A_PCM*``, SMFF ``pcm16`` / ``l16``) and ``A_MS/ACM`` at format tags
  7 (µ-law), 6 (A-law) and 1 (PCM); the two G.711 tags decode with
  ``ops/g711`` on the player's device, read back once a file.
  Video tracks (MKV ``V_VP8`` or ``V_MPEG4/ISO/AVC``, SMFF ``vp8``) queue
  into a ``core/worker.StreamRegulator`` and decode on the host
  (``ops/vp8``, ``ops/h264``) when the play position reaches their
  timestamp; ``on_video((y, u, v))`` gets each frame.
* ``MediaRecorder``: a 1-leg ``file_recorder`` fed by ``set_input``;
  ``stop_and_save`` writes ``.wav`` (PCM16), ``.smff`` (pcm16, and VP8
  video after ``enable_video`` / ``push_video_frame``) or ``.mkv`` /
  ``.webm`` (Opus and VP8, ``write_av_mkv``).

``device=None`` runs on ``cuda`` and raises without a card
(``core/ticker.resolve_device``); tests pass ``"cpu"``. A video track whose
library is missing (libvpx for VP8, libavcodec for H.264) raises
``RuntimeError`` naming it, where the JAX package's player skips the track
and plays the audio.
"""
from __future__ import annotations

import struct
from typing import Callable, Optional

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.block import Format, tick_samples
from mediastreamer2_tpu_torch.core.graph import GraphBuilder
from mediastreamer2_tpu_torch.core.ticker import Ticker, resolve_device
from mediastreamer2_tpu_torch.io.wav import read_wav, write_wav


def _require(available: bool, what: str, library: str):
    if not available:
        raise RuntimeError(f"{what} needs {library}, which is not available on this host")


class MediaPlayer:
    """Single-leg convenience wrapper (batch=1) with the reference's
    play/pause/seek/EOF surface."""

    STATE_CLOSED, STATE_PAUSED, STATE_PLAYING = "closed", "paused", "playing"

    def __init__(self, factory, out_rate: Optional[int] = None, device=None):
        self.factory = factory
        self.out_rate = out_rate
        self.device = resolve_device(device)
        self.state = self.STATE_CLOSED
        self.ticker: Optional[Ticker] = None
        self.rate = 0
        self.on_eof: Optional[Callable[[], None]] = None
        self._spk_cb: Optional[Callable[[np.ndarray], None]] = None
        # video branch (A/V files): on_video((y, u, v)) paced by timestamps
        self.on_video: Optional[Callable[[tuple], None]] = None
        self._video_reg = None
        self._video_dec = None
        self.video_frames_played = 0

    def open(self, path: str):
        """Sniffs the container by extension: .mkv/.webm/.mka and .smff
        demuxed host-side, anything else read as WAV (cf. msmediaplayer.c
        open/sniff)."""
        if path.lower().endswith((".mkv", ".webm", ".mka")):
            sig, rate = _read_mkv_audio(path, self.device)
            self._open_mkv_video(path)
        elif path.lower().endswith(".smff"):
            sig, rate = _read_smff_audio(path)
            self._open_smff_video(path)
        else:
            sig, rate = read_wav(path)
        self.rate = rate
        g = GraphBuilder(self.factory, batch=1)
        p = g.add("file_player", "play", fmt=Format(rate=rate), signal=sig)
        last = p
        if self.out_rate and self.out_rate != rate:
            rs = g.add("resample", "rs", out_rate=self.out_rate)
            g.link(last, 0, rs, 0)
            last = rs
        g.link(last, 0, g.add("ext_sink", "spk"), 0)
        self.ticker = Ticker(g.build(), device=self.device, name="mediaplayer")
        self._set_play_param("playing", False)
        self.ticker.event_queue.set_handler(
            "play.eof", lambda ev: self.on_eof and self.on_eof())
        if self._video_reg is not None:
            # the play position, read back with each tick's output, paces
            # the video frames
            self.ticker.readback_state = [("play", "pos")]
        self.ticker.set_io(push=self._push)
        self.ticker.warm_up()
        self.state = self.STATE_PAUSED
        self.duration_ms = len(sig) * 1000 // rate

    def _open_mkv_video(self, path: str):
        """Video branch (msmediaplayer.c's player->decoder->display chain):
        VP8 or H.264 track frames queue into a StreamRegulator and decode
        on release, delivered via on_video((y, u, v))."""
        from mediastreamer2_tpu_torch.core.worker import StreamRegulator
        from mediastreamer2_tpu_torch.io.mkv import MkvReader, TRACK_TYPE_VIDEO
        r = MkvReader(path)
        track = next(((n, t) for n, t in r.tracks.items()
                      if t.type == TRACK_TYPE_VIDEO
                      and t.codec_id in ("V_VP8", "V_MPEG4/ISO/AVC")), None)
        if track is None:
            return
        vnum, t = track
        if t.codec_id == "V_VP8":
            from mediastreamer2_tpu_torch.ops.vp8 import Vp8Decoder, vp8_available
            _require(vp8_available(), f"{path}: the V_VP8 track", "libvpx")
            dec = Vp8Decoder()
        else:
            from mediastreamer2_tpu_torch.ops.h264 import h264_available
            _require(h264_available(), f"{path}: the V_MPEG4/ISO/AVC track", "libavcodec")
            avcc = _parse_avcc(t.codec_private)
            if avcc is None:
                return
            dec = _AvccDecoder(*avcc)
        reg = StreamRegulator(clock_rate=1000)        # mkv timecodes in ms
        for fr in r.frames():
            if fr.track == vnum:
                reg.push(fr.ts_ms, fr.data)
        self._video_reg = reg
        self._video_dec = dec

    def _open_smff_video(self, path: str):
        """SMFF video track (vp8) -> same regulator-paced branch."""
        from mediastreamer2_tpu_torch.core.worker import StreamRegulator
        from mediastreamer2_tpu_torch.io.smff import KIND_VIDEO, SmffReader
        r = SmffReader(path)
        vidx = next((i for i, t in enumerate(r.tracks)
                     if t.kind == KIND_VIDEO and t.codec == "vp8"), None)
        if vidx is None:
            return
        from mediastreamer2_tpu_torch.ops.vp8 import Vp8Decoder, vp8_available
        _require(vp8_available(), f"{path}: the vp8 track", "libvpx")
        reg = StreamRegulator(clock_rate=1000)
        for fr in r.frames():
            if fr.track == vidx:
                reg.push(fr.ts_ms, fr.data)
        self._video_reg = reg
        self._video_dec = Vp8Decoder()

    def _set_play_param(self, key: str, value: bool):
        """Set a file_player param on the ticker's stream at the next tick
        boundary."""
        self.ticker.mutate(lambda tk: tk.params["play"][key].fill_(value))

    def _push(self, tick, ext_out):
        if self._spk_cb:
            self._spk_cb(ext_out["spk"][0])
        if self._video_reg is not None:
            # release frames whose timestamp the stream clock (the play
            # position in whole ms, as get_position_ms) has reached
            now_s = (int(ext_out["play.pos"][0]) * 1000 // self.rate) / 1e3
            for data in self._video_reg.pop_due(now_s):
                out = self._video_dec.decode(data)
                if out is not None:
                    self.video_frames_played += 1
                    if self.on_video:
                        self.on_video(out)

    def set_output(self, cb: Callable[[np.ndarray], None]):
        self._spk_cb = cb

    def start(self):
        if self.state == self.STATE_CLOSED:
            raise RuntimeError("open() first")
        self._set_play_param("playing", True)
        if not self.ticker._run_thread:
            self.ticker.start()
        self.state = self.STATE_PLAYING

    def pause(self):
        self._set_play_param("playing", False)
        self.state = self.STATE_PAUSED

    def set_loop(self, enabled: bool = True):
        """MS_PLAYER_SET_LOOP (player tester 'Loop test'): wrap to the
        start at EOF instead of stopping."""
        self._set_play_param("loop", enabled)

    def seek_ms(self, ms: int):
        pos = int(ms * self.rate / 1000)
        self.ticker.mutate(lambda tk: tk.state["play"]["pos"].fill_(pos))

    def get_position_ms(self) -> int:
        """The play position (a read of the device state: waits for the
        ticker's stream)."""
        return int(self.ticker.host(self.ticker.state["play"]["pos"])[0]) * 1000 // self.rate

    def close(self):
        if self.ticker:
            self.ticker.stop()
        self.state = self.STATE_CLOSED


class _AvccDecoder:
    """H.264 from an MKV AVC track: length-prefixed NALs to Annex B (the
    parameter sets of the codec-private ahead of the first frame), decoded
    to (y, u, v) planes like ``Vp8Decoder``."""

    def __init__(self, nal_len_size: int, param_sets):
        from mediastreamer2_tpu_torch.ops.h264 import H264Decoder
        self.h264 = H264Decoder()
        self.nal_len_size = nal_len_size
        self.header = b"".join(b"\x00\x00\x00\x01" + n for n in param_sets)

    def decode(self, data: bytes):
        out = bytearray(self.header)
        self.header = b""
        n, off = self.nal_len_size, 0
        while off + n <= len(data):
            ln = int.from_bytes(data[off:off + n], "big")
            off += n
            out += b"\x00\x00\x00\x01" + data[off:off + ln]
            off += ln
        frames = self.h264.decode(bytes(out))
        if not frames:
            return None
        w, h = self.h264.width, self.h264.height
        buf = np.frombuffer(frames[-1], np.uint8)
        y = buf[: w * h].reshape(h, w)
        u = buf[w * h: w * h + w * h // 4].reshape(h // 2, w // 2)
        v = buf[w * h + w * h // 4:].reshape(h // 2, w // 2)
        return y, u, v


def _parse_avcc(priv: bytes):
    """AVCDecoderConfigurationRecord -> (nal_length_size, [sps..., pps...])
    (the codec-private handling of the reference's mkv player,
    mkv.cpp codec-private paths)."""
    if len(priv) < 7 or priv[0] != 1:
        return None
    nal_len_size = (priv[4] & 0x03) + 1
    sets = []
    off = 5
    n_sps = priv[off] & 0x1F
    off += 1
    for _ in range(n_sps):
        ln = int.from_bytes(priv[off:off + 2], "big")
        off += 2
        sets.append(priv[off:off + ln])
        off += ln
    if off < len(priv):
        n_pps = priv[off]
        off += 1
        for _ in range(n_pps):
            ln = int.from_bytes(priv[off:off + 2], "big")
            off += 2
            sets.append(priv[off:off + ln])
            off += ln
    return nal_len_size, sets


def _read_smff_audio(path: str):
    """Demux the SMFF container's audio track (cf. smff/player.cpp):
    opus or pcm16 payloads -> one decoded signal."""
    from mediastreamer2_tpu_torch.io.smff import SmffReader
    r = SmffReader(path)
    audio_idx = next((i for i, t in enumerate(r.tracks) if t.kind == 0), None)
    if audio_idx is None:
        raise ValueError("no audio track in smff")
    track = r.tracks[audio_idx]
    rate = track.a or 48000
    chunks = []
    if track.codec == "opus":
        from mediastreamer2_tpu_torch.ops.host_codecs import OpusDecoder
        dec = OpusDecoder(rate=rate)
        for fr in r.frames():
            if fr.track == audio_idx:
                chunks.append(dec.decode(fr.data, rate // 50))
    elif track.codec in ("pcm16", "l16"):
        for fr in r.frames():
            if fr.track == audio_idx:
                chunks.append(np.frombuffer(fr.data, "<i2").astype(np.float32) / 32768.0)
    else:
        raise ValueError(f"unsupported smff audio codec {track.codec}")
    sig = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    return sig, rate


def _read_mkv_audio(path: str, device=None):
    """Decode the first audio track of an MKV to PCM (Opus or PCM codecs);
    G.711 ACM tracks decode on ``device`` (None: the card)."""
    from mediastreamer2_tpu_torch.io.mkv import MkvReader, TRACK_TYPE_AUDIO
    r = MkvReader(path)
    track = next((t for t in r.tracks.values() if t.type == TRACK_TYPE_AUDIO), None)
    if track is None:
        raise ValueError("no audio track")
    rate = int(track.sampling_rate) or 48000
    if track.codec_id == "A_OPUS":
        from mediastreamer2_tpu_torch.ops.host_codecs import OpusDecoder
        dec = OpusDecoder(rate=rate, channels=max(track.channels, 1))
        frame = rate // 100                      # our recorder writes 10 ms
        chunks = [dec.decode(f.data, frame * 6)  # decode up to 60 ms frames
                  for f in r.frames() if f.track == track.number]
        sig = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    elif track.codec_id.startswith("A_PCM"):
        data = b"".join(f.data for f in r.frames() if f.track == track.number)
        sig = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    elif track.codec_id == "A_MS/ACM":
        # WAVEFORMATEX in codec-private: format tag 7 = mu-law, 6 = a-law,
        # 1 = pcm16 (the reference's mkv ACM handling)
        tag = struct.unpack_from("<H", track.codec_private, 0)[0] \
            if len(track.codec_private) >= 2 else 1
        data = b"".join(f.data for f in r.frames() if f.track == track.number)
        if tag in (6, 7):
            from mediastreamer2_tpu_torch.ops.g711 import alaw_decode, ulaw_decode
            codes = torch.from_numpy(np.frombuffer(data, np.uint8).astype(np.int32))
            pcm = (ulaw_decode if tag == 7 else alaw_decode)(codes.to(resolve_device(device)))
            sig = pcm.cpu().numpy().astype(np.float32) / 32768.0
        else:
            sig = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
    else:
        raise ValueError(f"unsupported mkv audio codec {track.codec_id}")
    return sig, rate


class MediaRecorder:
    """WAV / SMFF / MKV recorder fed by an external source callback (mic or
    graph)."""

    def __init__(self, factory, rate: int = 8000, max_seconds: int = 600, device=None):
        self.factory = factory
        self.rate = rate
        self.S = tick_samples(rate)
        g = GraphBuilder(factory, batch=1)
        src = g.add("ext_source", "mic", fmt=Format(rate=rate))
        g.link(src, 0, g.add("file_recorder", "rec", max_ticks=max_seconds * 100), 0)
        self.graph = g.build()
        self.ticker = Ticker(self.graph, device=device, name="mediarecorder")
        self._pull_cb: Optional[Callable[[int], np.ndarray]] = None
        self.ticker.set_io(pull=self._pull)
        # optional video track: the app pushes packed-I420 blocks, encoded
        # VP8 at save time (msmediarecorder.c's A/V recording)
        self._video_frames: list = []       # [(ts_ms, block)]
        self._video_wh = None

    def set_input(self, cb: Callable[[int], np.ndarray]):
        self._pull_cb = cb

    def enable_video(self, width: int, height: int):
        from mediastreamer2_tpu_torch.ops.vp8 import vp8_available
        _require(vp8_available(), "the recorder's VP8 video track", "libvpx")
        self._video_wh = (width, height)

    def push_video_frame(self, block: np.ndarray):
        """Append one packed-I420 float block [h*3/2, w] at the current
        stream position."""
        if self._video_wh is None:
            raise RuntimeError("enable_video first")
        self._video_frames.append((self.ticker.stats.ticks * 10, np.asarray(block)))

    def _pull(self, tick):
        if self._pull_cb is None:
            return {"mic": np.zeros((1, self.S), np.float32)}
        return {"mic": np.asarray(self._pull_cb(tick), np.float32).reshape(1, self.S)}

    def start(self, n_ticks: int = 10 ** 9):
        self.ticker.warm_up()
        self.ticker.start(n_ticks)

    def run(self, n_ticks: int):
        self.ticker.warm_up()
        self.ticker.run(n_ticks)

    def stop_and_save(self, path: str):
        """Saves .wav (PCM16), .smff (pcm16 + VP8) or .mkv/.webm (Opus +
        VP8) by extension (cf. msmediarecorder.c wav/mkv)."""
        from mediastreamer2_tpu_torch.ops.fileio import recorder_get_audio
        self.ticker.stop()
        n = int(self.ticker.host(self.ticker.state["rec"]["tick"]))
        audio = recorder_get_audio(self.ticker.state["rec"], n, self.S)[0]
        if path.lower().endswith((".mkv", ".webm")):
            write_av_mkv(path, audio, self.rate, self._video_frames, self._video_wh)
        elif path.lower().endswith(".smff"):
            # the reference's 'Record .smff' case, in the wire-compatible
            # container (io/smff.py): pcm16 audio, 10 ms a record, and VP8
            from mediastreamer2_tpu_torch.io.smff import (KIND_AUDIO, KIND_VIDEO, SmffTrack,
                                                          SmffWriter)
            video = bool(self._video_wh and self._video_frames)
            tracks = [SmffTrack(KIND_AUDIO, "pcm16", self.rate, 1)]
            if video:
                venc = _vp8_encoder(self._video_frames, self._video_wh)
                tracks.append(SmffTrack(KIND_VIDEO, "vp8", *self._video_wh))
            w = SmffWriter(path, tracks)
            F = self.rate // 100
            pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2")
            for i in range(len(pcm) // F):
                w.write_frame(0, i * 10, pcm[i * F:(i + 1) * F].tobytes())
            if video:
                for ts_ms, data, key in _vp8_frames(venc, self._video_frames, self._video_wh):
                    w.write_frame(1, ts_ms, data, keyframe=key)
            w.close()
        else:
            write_wav(path, audio, self.rate)
        return path


def _vp8_encoder(frames, wh):
    """The VP8 encoder of a recording's video track, at the frames' mean
    rate (raises ``RuntimeError`` naming libvpx where it is missing)."""
    from mediastreamer2_tpu_torch.ops.vp8 import Vp8Encoder
    return Vp8Encoder(wh[0], wh[1], fps=max(1, len(frames) * 1000
                                            // max(frames[-1][0] + 10, 10)))


def _vp8_frames(venc, frames, wh):
    """(ts_ms, VP8 frame, keyframe) for each (ts_ms, packed-I420 float
    block) the encoder returns data for; the first is forced a keyframe."""
    vw, vh = wh
    for k, (ts_ms, block) in enumerate(frames):
        arr = (np.clip(block, 0, 1) * 255).astype(np.uint8)
        uv = arr[vh:].reshape(vh // 2, 2, vw // 2)
        data, key = venc.encode_planes(arr[:vh], uv[:, 0], uv[:, 1], force_keyframe=(k == 0))
        if data:
            yield ts_ms, data, key


def write_av_mkv(path: str, audio: np.ndarray, rate: int, frames, wh: Optional[tuple]):
    """The A/V MKV writer of MediaRecorder and of the call recording
    (``AudioStreamBatch.save_av_recording``): an Opus audio track, 10 ms a
    frame, and a VP8 track from (ts_ms, packed-I420 float block) frames.
    The encoders are made before the file, so a host without libopus or
    (with frames) libvpx raises ``RuntimeError`` and writes nothing."""
    from mediastreamer2_tpu_torch.io.mkv import (MkvTrack, MkvWriter, TRACK_TYPE_AUDIO,
                                                 TRACK_TYPE_VIDEO)
    from mediastreamer2_tpu_torch.ops.host_codecs import OpusEncoder
    if rate not in (8000, 12000, 16000, 24000, 48000):
        raise ValueError("opus mkv needs an opus-compatible rate")
    enc = OpusEncoder(rate=rate)
    video = bool(wh and frames)
    tracks = [MkvTrack(1, TRACK_TYPE_AUDIO, "A_OPUS", sampling_rate=rate, channels=1)]
    if video:
        venc = _vp8_encoder(frames, wh)
        tracks.append(MkvTrack(2, TRACK_TYPE_VIDEO, "V_VP8", width=wh[0], height=wh[1]))
    w = MkvWriter(path, tracks)
    F = rate // 100
    for i in range(len(audio) // F):
        w.write_frame(1, i * 10, enc.encode(audio[i * F:(i + 1) * F]))
    if video:
        for ts_ms, data, key in _vp8_frames(venc, frames, wh):
            w.write_frame(2, ts_ms, data, keyframe=key)
    w.close()
