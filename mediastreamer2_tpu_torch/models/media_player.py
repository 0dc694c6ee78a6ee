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
* ``MediaRecorder``: a 1-leg ``file_recorder`` fed by ``set_input``;
  ``stop_and_save`` writes ``.wav`` (PCM16), ``.smff`` (pcm16) or
  ``.mkv`` / ``.webm`` (Opus, ``write_av_mkv``).

``device=None`` runs on ``cuda`` and raises without a card
(``core/ticker.resolve_device``); tests pass ``"cpu"``.

Waiting for the video path (the VP8 and H.264 decoders and encoders and
``core/worker.StreamRegulator``, not ported to mediastreamer2_tpu_torch
yet), each raising ``NotImplementedError`` that names it: opening a file
with a VP8 or H.264 track, ``on_video``, ``enable_video`` /
``push_video_frame`` and the VP8 track of ``write_av_mkv``.
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

VIDEO_WAIT = ("video playback and recording wait for the VP8 / H.264 codecs and "
              "core/worker.StreamRegulator, not ported to mediastreamer2_tpu_torch yet")


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

    @property
    def on_video(self):
        return None

    @on_video.setter
    def on_video(self, cb):
        raise NotImplementedError(VIDEO_WAIT)

    def open(self, path: str):
        """Sniffs the container by extension: .mkv/.webm/.mka and .smff
        demuxed host-side, anything else read as WAV (cf. msmediaplayer.c
        open/sniff)."""
        if path.lower().endswith((".mkv", ".webm", ".mka")):
            _refuse_mkv_video(path)
            sig, rate = _read_mkv_audio(path, self.device)
        elif path.lower().endswith(".smff"):
            _refuse_smff_video(path)
            sig, rate = _read_smff_audio(path)
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
        self.ticker.set_io(push=self._push)
        self.ticker.warm_up()
        self.state = self.STATE_PAUSED
        self.duration_ms = len(sig) * 1000 // rate

    def _set_play_param(self, key: str, value: bool):
        """Set a file_player param on the ticker's stream at the next tick
        boundary."""
        self.ticker.mutate(lambda tk: tk.params["play"][key].fill_(value))

    def _push(self, tick, ext_out):
        if self._spk_cb:
            self._spk_cb(ext_out["spk"][0])

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


def _refuse_mkv_video(path: str):
    """Raise if the file has a VP8 or H.264 track (the player's video
    branch waits for the video path)."""
    from mediastreamer2_tpu_torch.io.mkv import MkvReader, TRACK_TYPE_VIDEO
    for t in MkvReader(path).tracks.values():
        if t.type == TRACK_TYPE_VIDEO and t.codec_id in ("V_VP8", "V_MPEG4/ISO/AVC"):
            raise NotImplementedError(f"{path}: {t.codec_id} track: {VIDEO_WAIT}")


def _refuse_smff_video(path: str):
    from mediastreamer2_tpu_torch.io.smff import KIND_VIDEO, SmffReader
    for t in SmffReader(path).tracks:
        if t.kind == KIND_VIDEO and t.codec == "vp8":
            raise NotImplementedError(f"{path}: vp8 track: {VIDEO_WAIT}")


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

    def set_input(self, cb: Callable[[int], np.ndarray]):
        self._pull_cb = cb

    def enable_video(self, width: int, height: int):
        raise NotImplementedError(VIDEO_WAIT)

    def push_video_frame(self, block: np.ndarray):
        raise NotImplementedError(VIDEO_WAIT)

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
        """Saves .wav (PCM16), .smff (pcm16) or .mkv/.webm (Opus) by
        extension (cf. msmediarecorder.c wav/mkv)."""
        from mediastreamer2_tpu_torch.ops.fileio import recorder_get_audio
        self.ticker.stop()
        n = int(self.ticker.host(self.ticker.state["rec"]["tick"]))
        audio = recorder_get_audio(self.ticker.state["rec"], n, self.S)[0]
        if path.lower().endswith((".mkv", ".webm")):
            write_av_mkv(path, audio, self.rate, [], None)
        elif path.lower().endswith(".smff"):
            # the reference's 'Record .smff' case, in the wire-compatible
            # container (io/smff.py): pcm16 audio, 10 ms a record
            from mediastreamer2_tpu_torch.io.smff import KIND_AUDIO, SmffTrack, SmffWriter
            w = SmffWriter(path, [SmffTrack(KIND_AUDIO, "pcm16", self.rate, 1)])
            F = self.rate // 100
            pcm = np.clip(audio * 32768.0, -32768, 32767).astype("<i2")
            for i in range(len(pcm) // F):
                w.write_frame(0, i * 10, pcm[i * F:(i + 1) * F].tobytes())
            w.close()
        else:
            write_wav(path, audio, self.rate)
        return path


def write_av_mkv(path: str, audio: np.ndarray, rate: int, frames, wh: Optional[tuple]):
    """The A/V MKV writer of MediaRecorder and of the call recording
    (``AudioStreamBatch.save_av_recording``): an Opus audio track, 10 ms a
    frame. Video ``frames`` (a VP8 track) wait for the video path. The
    encoder is made before the file, so a host without libopus raises
    ``RuntimeError`` and writes nothing."""
    from mediastreamer2_tpu_torch.io.mkv import MkvTrack, MkvWriter, TRACK_TYPE_AUDIO
    from mediastreamer2_tpu_torch.ops.host_codecs import OpusEncoder
    if wh and frames:
        raise NotImplementedError(VIDEO_WAIT)
    if rate not in (8000, 12000, 16000, 24000, 48000):
        raise ValueError("opus mkv needs an opus-compatible rate")
    enc = OpusEncoder(rate=rate)
    w = MkvWriter(path, [MkvTrack(1, TRACK_TYPE_AUDIO, "A_OPUS", sampling_rate=rate,
                                  channels=1)])
    F = rate // 100
    for i in range(len(audio) // F):
        w.write_frame(1, i * 10, enc.encode(audio[i * F:(i + 1) * F]))
    w.close()
