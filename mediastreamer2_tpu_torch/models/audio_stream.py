"""AudioStreamBatch -- the session-level duplex audio call builder (port of
``mediastreamer2_tpu/models/audio_stream.py``; the reference's
``audio_stream_start_full``, src/voip/audiostream.c).

One AudioStreamBatch hosts N call legs that share one graph and one
``Ticker``: the batch dimension replaces the reference's ticker thread per
stream. Feature flags select which nodes are built; per-leg params switch
them at run time.

    recv:  rtp_rx -> decoder -> plc -> dtmf_gen -> vol_recv ==> spk
    send:  mic -> ec(near=mic, far=spk) -> vol_send -> vad -> enc -> rtp_tx

``conference=True`` builds the server shape: each leg's decoded audio goes
through ``audio_levels`` into the deployment-wide ``conf_mixer`` and the
mix-minus is re-encoded back to that leg.

Host side, per tick: the per-leg ``RtpSession`` path (transports ->
jitter buffers -> payload block + lost mask) or the native batched edge
(``enable_batch_edge``: one recvmmsg drain and jitter-ring playout, one
sendmmsg for all legs).

Covered: the device codecs ``ulaw``, ``alaw``, ``l16`` and ``g722`` (16 kHz
audio on an 8 kHz RTP clock, one code byte per slot, its recurrence in one
kernel launch a tick) on both paths; SRTP per leg (``enable_srtp``,
``enable_double_srtp`` with EKT) and on the batch edge (``srtp_keys``),
with encryption-mandatory legs; RTCP (SR/RR + SDES every interval, BYE on
``stop``), ``iterate`` and the QoS controllers (bitrate controller,
quality indicator, bandwidth controller, TMMBR/REMB caps); directions, mic
and speaker gains, ``mute_rtp``, ptime, recording (``record_mixed`` too),
``local_play`` / ``play_announcement``, RFC 4733 DTMF send and receive,
``conference=True``, DTX with RFC 3389 CN, and a duck-typed sound card
(``pull(tick, B)`` / ``push(tick, block)``). ``device=None`` runs on
``cuda`` (raising without a card); tests pass ``"cpu"``.

Per-tick writes go into tensors the ticker already holds, on its
stream: the PLC ``lost`` mask (``Ticker.write_param`` into the PLC's
host-side param; the PLC uploads its per-leg controls in one copy)
and the echo limiter's ``peer_energy`` (a device copy of the previous
tick's ``vol_recv`` energy: one tick of delay, since the copy runs before
the step). The VAD's ``voice`` (and ``floor`` for CN) travel
with the tick's output readback (``Ticker.readback_state``), as does
``vol_send``'s energy for RFC 6464 levels.

The batch edge sends with UDP GSO only where ``native.udp_gso_supported()``
says the kernel takes it, and by sendmmsg elsewhere (the JAX package turns
GSO on unconditionally, which drops every packet under gVisor).

Waiting, each raising ``NotImplementedError`` that names its wait: host
codecs (opus, gsm, g729, speex, bv16, aac) wait for ``ops/host_codecs``;
``g726_32`` for its op; Baudot for ``ops/baudot``; the video link and A/V
recording for the video stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.block import Format, tick_samples
from mediastreamer2_tpu_torch.core.graph import GraphBuilder
from mediastreamer2_tpu_torch.core.ticker import Ticker
from mediastreamer2_tpu_torch.net.jitter import JBParams, JitterBuffer
from mediastreamer2_tpu_torch.net.rtp import RtpSession, Transport

# payload-type profile (RFC 3551 static types + dynamic ones)
PAYLOAD_TYPES = {"ulaw": 0, "alaw": 8, "l16": 11, "gsm": 3, "opus": 96,
                 "g722": 9, "g726_32": 97, "g729": 18, "aac": 98,
                 "bv16": 107, "speex": 110}
CN_PT = 13   # RFC 3389 comfort noise
CODEC_BYTES_PER_SAMPLE = {"ulaw": 1, "alaw": 1, "l16": 2, "g722": 1}
# RFC 3551 quirk: G.722 runs 16 kHz audio on an 8 kHz RTP clock (4.5.2);
# its payload and timestamps advance at half the sample rate (msg722.c:169)
RTP_CLOCK = {"g722": 8000}
DEVICE_CODECS = ("ulaw", "alaw", "l16", "g722")
HOST_CODECS = ("opus", "gsm", "g729", "bv16", "speex", "aac")
# codec byte that decodes to digital silence (RFC 3551 silence codes)
SILENCE_CODE = {"ulaw": 0xFF, "alaw": 0xD5}


def _codec_wait(codec: str) -> str:
    if codec in HOST_CODECS:
        return (f"codec {codec!r}: host codecs wait for ops/host_codecs, not ported "
                f"to mediastreamer2_tpu_torch yet")
    if codec == "g726_32":
        return f"codec {codec!r} waits for its op, not ported to mediastreamer2_tpu_torch yet"
    return f"unknown codec {codec!r}"


@dataclasses.dataclass
class AudioStreamFeatures:
    """cf. AUDIO_STREAM_FEATURE_* bitmask (audiostream.c)."""
    echo_canceller: bool = False
    agc: bool = False
    noise_gate: bool = False
    plc: bool = True
    vad_dtx: bool = False
    dtmf: bool = False
    volume: bool = True
    baudot: bool = False       # waits for ops/baudot
    local_play: bool = False   # announcement mixer into the send path
    mic_eq_gains: Optional[list] = None     # [(hz, gain, width_hz), ...]
    spk_eq_gains: Optional[list] = None
    ec_delay_ms: int = 0


class AudioStreamBatch:
    """N duplex audio legs, one device program."""

    batch_edge = False

    def __init__(self, factory, batch: int, codec: str = "ulaw",
                 rate: int = 8000, channels: int = 1,
                 features: Optional[AudioStreamFeatures] = None,
                 mic_signal: Optional[np.ndarray] = None,
                 record_ticks: int = 0,
                 record_mixed: bool = False,
                 jb_params: Optional[JBParams] = None,
                 conference: bool = False,
                 snd_card=None,
                 device=None):
        """record_mixed=True records mic + received audio mixed (the
        reference's mixed-call recording, audiostream.c:1068-1088) instead
        of the receive side only. conference=True builds the server shape
        (see the module docstring)."""
        if codec not in DEVICE_CODECS:
            raise NotImplementedError(_codec_wait(codec))
        if channels != 1:
            raise ValueError("multichannel audio requires opus or aac")
        self.factory = factory
        self.batch = batch
        self.codec = codec
        self.rate = rate
        self.channels = channels
        self.S = tick_samples(rate) * channels
        self.rtp_clock = RTP_CLOCK.get(codec, rate)
        self.S_rtp = tick_samples(self.rtp_clock)
        self.features = features or AudioStreamFeatures()
        ft = self.features
        if ft.baudot:
            raise NotImplementedError("Baudot TTY waits for ops/baudot, not ported to "
                                      "mediastreamer2_tpu_torch yet")
        self.record_ticks = record_ticks
        self.snd_card = snd_card
        fmt = Format(kind="pcm", rate=rate, channels=channels)

        g = GraphBuilder(factory, batch=batch)
        # ---- recv chain (built first: its output feeds the EC far pin) ----
        rx = g.add("ext_source", "rtp_rx", fmt=fmt.with_(kind=codec, rate=self.rtp_clock))
        last = g.add(f"{codec}_dec", "dec")
        g.link(rx, 0, last, 0)
        if ft.plc:
            last = self._append(g, last, "generic_plc", "plc")
        if ft.dtmf:
            last = self._append(g, last, "dtmf_gen", "dtmf")
        if ft.volume:
            last = self._append(g, last, "volume", "vol_recv")
        if ft.spk_eq_gains:
            last = self._append(g, last, "equalizer", "spk_eq", gains=ft.spk_eq_gains)
        self.conference = conference
        if conference:
            last = self._append(g, last, "audio_levels", "levels")
            last = self._append(g, last, "conf_mixer", "conf")
        spk_tee = g.add("tee", "spk_tee")
        g.link(last, 0, spk_tee, 0)
        g.link(spk_tee, 0, g.add("ext_sink", "spk"), 0)
        self.record_mixed = record_mixed and not conference
        rec_mix = None
        if record_ticks and self.record_mixed:
            rec_mix = g.add("mix2", "rec_mix")
            g.link(spk_tee, 1, rec_mix, 0)
            g.link(rec_mix, 0, g.add("file_recorder", "rec", max_ticks=record_ticks), 0)
        elif record_ticks:
            g.link(spk_tee, 1, g.add("file_recorder", "rec", max_ticks=record_ticks), 0)

        # ---- send chain ----------------------------------------------------
        if conference:
            # server: re-encode each member's mix-minus output; no mic / EC
            enc = g.add(f"{codec}_enc", "enc")
            g.link(spk_tee, 3, enc, 0)
            g.link(enc, 0, g.add("ext_sink", "rtp_tx"), 0)
            self._finish_init(batch, jb_params, g, device)
            return
        if mic_signal is not None:
            last = g.add("file_player", "mic", fmt=fmt, signal=mic_signal)
        else:
            last = g.add("ext_source", "mic", fmt=fmt)
        if ft.mic_eq_gains:
            last = self._append(g, last, "equalizer", "mic_eq", gains=ft.mic_eq_gains)
        if ft.echo_canceller:
            ec = g.add("echo_canceller", "ec")
            g.link(last, 0, ec, 0)
            if ft.ec_delay_ms:
                # align the far reference with the echo path (the quirk
                # DB's delay hint, audiostream.c:1642-1680)
                dl = g.add("delay_line", "ec_delay", max_delay_ms=max(200, ft.ec_delay_ms))
                g.link(spk_tee, 2, dl, 0)
                g.link(dl, 0, ec, 1)
            else:
                g.link(spk_tee, 2, ec, 1)      # far-end reference = speaker
            last = ec
        if ft.volume or ft.agc or ft.noise_gate:
            last = self._append(g, last, "volume", "vol_send")
        if ft.vad_dtx:
            last = self._append(g, last, "vad_dtx", "vad")
        if ft.local_play:
            # announcement player mixed into the outgoing audio
            player = g.add("file_player", "announce", fmt=fmt,
                           signal=np.zeros(self.S, np.float32))
            mx = g.add("mix2", "announce_mix")
            g.link(last, 0, mx, 0)
            g.link(player, 0, mx, 1)
            last = mx
        if rec_mix is not None:
            send_tee = g.add("tee", "send_tee")
            g.link(last, 0, send_tee, 0)
            g.link(send_tee, 1, rec_mix, 1)
            last = send_tee
        enc = g.add(f"{codec}_enc", "enc")
        g.link(last, 0, enc, 0)
        g.link(enc, 0, g.add("ext_sink", "rtp_tx"), 0)
        self._finish_init(batch, jb_params, g, device)

    @staticmethod
    def _append(g, last, filt, name, **kw):
        node = g.add(filt, name, **kw)
        g.link(last, 0, node, 0)
        return node

    def _finish_init(self, batch, jb_params, g, device):
        ft = self.features
        self.graph = g.build()
        self.ticker = Ticker(self.graph, device=device, name=f"audio[{batch}]", realtime=True)
        self.device = self.ticker.device
        self.ticker.set_io(pull=self._pull, push=self._push)
        tk = self.ticker
        if ft.vad_dtx:
            tk.readback_state += [("vad", "voice"), ("vad", "floor")]
        if "vol_send" in tk.state:
            tk.readback_state.append(("vol_send", "energy"))
            with tk.on_stream():
                if ft.agc:
                    tk.params["vol_send"]["agc_enabled"].fill_(True)
                if ft.noise_gate:
                    tk.params["vol_send"]["ng_enabled"].fill_(True)
            tk.sync()

        # host-side per-leg sessions (bound later via set_transport)
        self.sessions: List[Optional[RtpSession]] = [None] * batch
        self.jb_params = jb_params or JBParams()
        self._was_voice = np.ones(batch, bool)
        self._rtp_muted = np.zeros(batch, bool)   # audio_stream_mute_rtp
        self._rx_muted = np.zeros(batch, bool)    # recv leg of set_direction
        self._direction = ["sendrecv"] * batch
        # runtime ptime (MS_AUDIO_ENCODER_SET_PTIME)
        self._ptime_ticks = [1] * batch
        self._max_ptime_ms = [100] * batch
        self._tx_tick_accum: List[list] = [[] for _ in range(batch)]
        self._rx_tick_fifo: List[list] = [[] for _ in range(batch)]
        self._srtp_info: Dict[int, tuple] = {}    # leg -> (suite, key source)
        self.bitrate_caps: Dict[int, int] = {}    # leg -> TMMBR/REMB cap, bps
        self.on_tmmbr = None                      # cb(leg, bps)
        self._brc: Dict[int, object] = {}         # leg -> BitrateController
        self._qi: Dict[int, object] = {}          # leg -> QualityIndicator
        self._bwc: Dict[int, object] = {}         # leg -> BandwidthController

    # ------------------------------------------------------------------
    def set_transport(self, leg: int, transport: Transport):
        self.sessions[leg] = RtpSession(
            transport, payload_type=PAYLOAD_TYPES[self.codec],
            clock_rate=self.rtp_clock, jitter_buffer=JitterBuffer(self.jb_params))
        # CN packets are accepted; their 1-byte payload routes to PLC / CN fill
        self.sessions[leg].accepted_payload_types = {PAYLOAD_TYPES[self.codec], CN_PT}

    # -- direction (media_stream_set_direction) ---------------------------
    def set_direction(self, leg: int, direction: str):
        """'sendrecv' | 'sendonly' | 'recvonly' | 'inactive': recv-muting
        silences the leg's playout, send-muting stops RTP emission (the
        clock keeps running)."""
        if direction not in ("sendrecv", "sendonly", "recvonly", "inactive"):
            raise ValueError(direction)
        self._rtp_muted[leg] = direction in ("recvonly", "inactive")
        self._rx_muted[leg] = direction in ("sendonly", "inactive")
        self._direction[leg] = direction

    def get_direction(self, leg: int) -> str:
        return self._direction[leg]

    # -- per-leg control surface (audio_stream_* setters) -----------------
    def _set_vol_param(self, node: str, key: str, leg: int, value):
        if node not in self.ticker.params:
            raise RuntimeError(f"stream built without {node} (volume off)")

        def fn(tk, node=node, key=key, leg=leg, value=value):
            tk.params[node][key][leg] = value
        self.ticker.mutate(fn)

    def enable_mic(self, leg: int, enabled: bool):
        """audio_stream_enable_mic (the send volume's mute switch)."""
        self._set_vol_param("vol_send", "mute", leg, not enabled)

    def set_mic_gain_db(self, leg: int, db: float):
        self._set_vol_param("vol_send", "static_gain", leg, 10.0 ** (db / 20.0))

    def set_spk_gain_db(self, leg: int, db: float):
        self._set_vol_param("vol_recv", "static_gain", leg, 10.0 ** (db / 20.0))

    def mute_rtp(self, leg: int, muted: bool = True):
        """audio_stream_mute_rtp: stop emitting RTP for the leg."""
        self._rtp_muted[leg] = muted

    def _mic_block(self, tick: int, B: int, S: int) -> np.ndarray:
        """Capture block: the sound card's samples when a card is set,
        silence otherwise."""
        if self.snd_card is not None:
            blk = self.snd_card.pull(tick, B)
            if blk.shape[1] != S:                 # rate-mismatched card
                out = np.zeros((B, S), np.float32)
                n = min(S, blk.shape[1])
                out[:, :n] = blk[:, :n]
                return out
            return blk
        return np.zeros((B, S), np.float32)

    def set_sound_card(self, card) -> None:
        """Hot-swap the capture/playback device (takes effect next tick)."""
        self.snd_card = card

    def link_video(self, video_stream, leg: int = 0, video_leg: int = 0):
        raise NotImplementedError("the video link waits for the video stream, not "
                                  "ported to mediastreamer2_tpu_torch yet")

    save_av_recording = link_video

    def enable_srtp(self, leg: int, tx_key: bytes, tx_salt: bytes,
                    rx_key: bytes, rx_salt: bytes, suite: str = None,
                    key_source: str = "sdes"):
        """media_stream_enable_srtp: wrap the leg's transport in SRTP, and
        its RTCP in SRTCP with the same keys (ms_srtp.cpp:1004-1019): a leg
        that negotiated SRTP never emits plaintext SR/RR. On a leg already
        encrypted, the contexts are swapped (a key change keeps one layer)."""
        from mediastreamer2_tpu_torch.net.srtp import (AES_CM_128_HMAC_SHA1_80, SrtcpContext,
                                                       SrtpContext, SrtpTransport)
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        suite = suite or AES_CM_128_HMAC_SHA1_80
        ctxs = dict(tx=SrtpContext(tx_key, tx_salt, suite), rx=SrtpContext(rx_key, rx_salt, suite),
                    tx_rtcp=SrtcpContext(tx_key, tx_salt, suite),
                    rx_rtcp=SrtcpContext(rx_key, rx_salt, suite))
        self._srtp_info[leg] = (suite, key_source)
        if isinstance(sess.transport, SrtpTransport):
            for k, v in ctxs.items():
                setattr(sess.transport, k, v)
            return
        sess.transport = SrtpTransport(sess.transport, **ctxs)

    def enable_double_srtp(self, leg: int, inner: tuple, outer: tuple,
                           suite: str = None, ekt_key: bytes = None, ekt_spi: int = 0):
        """Inner and outer SRTP on one leg (ms_srtp.cpp's double encryption);
        ``inner`` / ``outer`` are (tx_key, tx_salt, rx_key, rx_salt). With
        ``ekt_key``, RFC 8870 tags carry the inner key between the layers
        for relayed conferences."""
        from mediastreamer2_tpu_torch.net.srtp import (AES_CM_128_HMAC_SHA1_80, EktTransport,
                                                       SrtcpContext, SrtpContext, SrtpTransport)
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        suite = suite or AES_CM_128_HMAC_SHA1_80
        otk, ots, ork, ors = outer
        itk, its, irk, irs = inner
        t = SrtpTransport(sess.transport,
                          tx=SrtpContext(otk, ots, suite), rx=SrtpContext(ork, ors, suite),
                          tx_rtcp=SrtcpContext(otk, ots, suite),
                          rx_rtcp=SrtcpContext(ork, ors, suite))
        if ekt_key is not None:
            t = EktTransport(t, ekt_key=ekt_key, spi=ekt_spi, send_master_key=itk)
        sess.transport = SrtpTransport(t, tx=SrtpContext(itk, its, suite),
                                       rx=SrtpContext(irk, irs, suite))
        self._srtp_info[leg] = (suite, "sdes-double")

    def get_srtp_info(self, leg: int):
        """(crypto suite, key source), or None when the leg is not
        encrypted (media_stream_get_srtp_crypto_suite / _key_source)."""
        return self._srtp_info.get(leg)

    def secured(self, leg: int) -> bool:
        """media_stream_secured."""
        return leg in self._srtp_info

    def reclaim_sessions(self) -> List[Optional[RtpSession]]:
        """Detach the legs' RtpSessions for a replacement stream
        (media_stream_reclaim_sessions): SSRC, sequence numbering and
        transport survive."""
        out = list(self.sessions)
        self.sessions = [None] * self.batch
        return out

    def adopt_session(self, leg: int, session: RtpSession):
        """Attach a reclaimed session, re-pointed at this stream's codec."""
        session.reconfigure(PAYLOAD_TYPES[self.codec], self.rtp_clock,
                            JitterBuffer(self.jb_params))
        session.accepted_payload_types = {PAYLOAD_TYPES[self.codec], CN_PT}
        self.sessions[leg] = session

    def set_encryption_mandatory(self, leg: int, yesno: bool = True):
        """While this leg's transport is not SRTP, media and RTCP are
        dropped instead of sent in clear, and inbound plaintext is
        discarded (ms_srtp.cpp:1576)."""
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        sess.set_encryption_mandatory(yesno)

    def get_encryption_mandatory(self, leg: int) -> bool:
        sess = self.sessions[leg]
        return sess is not None and sess.encryption_mandatory

    # ------------------------------------------------------------------
    def _decode_payload(self, payload: bytes) -> np.ndarray:
        if self.codec == "l16":
            return np.frombuffer(payload, ">i2").astype(np.int32)
        return np.frombuffer(payload, np.uint8).astype(np.int32)

    def _encode_payload(self, row: np.ndarray) -> bytes:
        if self.codec == "l16":
            return row.astype(">i2").tobytes()
        return row.astype(np.uint8).tobytes()

    def enable_batch_edge(self, rx_sock, tx_sock, remote, ssrc_base: int = 0x5000,
                          prefill: int = 4, srtp_keys=None,
                          srtp_suite: str = "AES_CM_128_HMAC_SHA1_80"):
        """Replace the per-leg RTP path with the native batched edge: one
        send call for all legs (UDP GSO where the kernel takes it, else
        sendmmsg), one recvmmsg drain + jitter-ring playout per tick. Legs
        transmit SSRC ssrc_base+i and expect the same SSRCs inbound.

        srtp_keys: per-leg [(master_key, master_salt), ...]; SRTP
        (``srtp_suite``) then runs inline in the edge, protect on send and
        authenticate + decrypt before the jitter ring, and ``secured``
        reports those legs. A key the edge refuses raises."""
        from mediastreamer2_tpu_torch.native import (BatchRtpRx, BatchRtpTx,
                                                     udp_gso_supported)
        from mediastreamer2_tpu_torch.net.jitter import BatchEdgeJitterController
        if srtp_keys is not None and len(srtp_keys) != self.batch:
            raise ValueError(f"srtp_keys: {len(srtp_keys)} legs, expected {self.batch}")
        psz = self.S_rtp * CODEC_BYTES_PER_SAMPLE[self.codec]
        self._edge_tx = BatchRtpTx(tx_sock, self.batch, psz)
        self._edge_rx = BatchRtpRx(self.batch, psz, ring_depth=64)
        self._edge_rx.add_socket(rx_sock, gro=True)
        for i in range(self.batch):
            self._edge_tx.config(i, remote[0], remote[1], ssrc=ssrc_base + i,
                                 pt=PAYLOAD_TYPES[self.codec])
            self._edge_rx.map_ssrc(ssrc_base + i, i)
            self._edge_rx.set_prefill(i, prefill)
            if srtp_keys is not None:
                mk, ms = srtp_keys[i]
                self._edge_tx.set_srtp(i, mk, ms, srtp_suite)
                self._edge_rx.set_srtp(i, mk, ms, srtp_suite)
                self._srtp_info[i] = (srtp_suite, "sdes")
        self.gso = udp_gso_supported()
        if self.gso:
            self._edge_tx.enable_gso(remote)
        self._edge_jitter_ctrl = BatchEdgeJitterController(self._edge_rx, self.batch,
                                                           min_prefill=prefill)
        self.batch_edge = True

    def set_ptime(self, leg: int, ptime_ms: int):
        """MS_AUDIO_ENCODER_SET_PTIME: ptime_ms of audio per packet, clamped
        to the negotiated max_ptime."""
        assert ptime_ms % 10 == 0 and ptime_ms >= 10
        self._ptime_ticks[leg] = min(ptime_ms, self._max_ptime_ms[leg]) // 10

    def set_max_ptime(self, leg: int, max_ptime_ms: int):
        """fmtp maxptime=; out of range falls back to the reference's 100 ms."""
        if not 10 <= max_ptime_ms <= 140:
            max_ptime_ms = 100
        self._max_ptime_ms[leg] = max_ptime_ms
        if self._ptime_ticks[leg] * 10 > max_ptime_ms:
            self._ptime_ticks[leg] = max_ptime_ms // 10

    def get_ptime(self, leg: int) -> int:
        return self._ptime_ticks[leg] * 10

    # -- per-tick host I/O (run by the ticker on its stream) ----------------
    def _finish_pull(self, tick: int, rx, lost) -> Dict[str, np.ndarray]:
        if self.features.plc:
            self.ticker.write_param("plc", "lost", lost)
        self._feed_echo_limiter()
        ext = {"rtp_rx": rx}
        if "mic" in self.graph.ext_inputs:
            ext["mic"] = self._mic_block(tick, self.batch, self.S)
        return ext

    def _pull_batch_edge(self, tick: int) -> Dict[str, np.ndarray]:
        """Whole-batch pull: one poll + one playout pop. The payload matrix
        is uploaded narrow (uint8 codes, int16 samples) and widened on the
        device."""
        self._edge_rx.poll()
        pay, flags = self._edge_rx.read_tick()
        if self.codec == "l16":
            rx = pay.view(">i2").astype(np.int16).reshape(self.batch, self.S_rtp)
        else:
            rx = pay
        return self._finish_pull(tick, rx, flags == 0)

    def _push_batch_edge(self, tick: int, ext_out: Dict):
        tx = ext_out["rtp_tx"]
        if self.codec == "l16":
            payloads = np.ascontiguousarray(tx.astype(">i2")).view(np.uint8).reshape(
                self.batch, -1)
        else:
            payloads = tx.astype(np.uint8)
        mask = ext_out["vad.voice"].astype(np.uint8) if self.features.vad_dtx else None
        if self._rtp_muted.any():
            mask = (np.ones(self.batch, np.uint8) if mask is None else mask) \
                * (~self._rtp_muted).astype(np.uint8)
        self._edge_tx.send(payloads, ts_inc=self.S_rtp, mask=mask)

    def _pull(self, tick: int) -> Dict[str, np.ndarray]:
        if self.batch_edge:
            return self._pull_batch_edge(tick)
        B = self.batch
        rx = np.zeros((B, self.S_rtp), np.int32)
        lost = np.zeros(B, bool)
        tick_len = self.S_rtp * CODEC_BYTES_PER_SAMPLE[self.codec]
        for i, sess in enumerate(self.sessions):
            if sess is None:
                lost[i] = True
                continue
            sess.poll()
            if self._rx_muted[i]:
                # sendonly / inactive: discard inbound media
                sess.jitter_buffer.buf.clear()
                rx[i] = SILENCE_CODE.get(self.codec, 0)
                continue
            fifo = self._rx_tick_fifo[i]
            if not fifo:
                payload = sess.jitter_buffer.get_tick()
                if payload is not None and len(payload) >= tick_len \
                        and len(payload) % tick_len == 0:
                    # one packet may hold several ticks (sender ptime > 10)
                    fifo.extend(payload[k:k + tick_len]
                                for k in range(0, len(payload), tick_len))
            if fifo:
                rx[i] = self._decode_payload(fifo.pop(0))
            else:
                lost[i] = True
        return self._finish_pull(tick, rx, lost)

    def _feed_echo_limiter(self):
        """Duplex gain coupling: vol_send ducks while vol_recv (speaker) is
        active (msvolume.c's echo-limiter peer). A device copy of the
        previous tick's energy into the param tensor, before the step: one
        tick of delay (a reference to the state tensor would see the
        current tick's value)."""
        st, pr = self.ticker.state, self.ticker.params
        if "vol_send" in pr and "vol_recv" in st:
            pr["vol_send"]["peer_energy"].copy_(st["vol_recv"]["energy"])

    def _push(self, tick: int, ext_out: Dict):
        if self.snd_card is not None and "spk" in ext_out:
            self.snd_card.push(tick, ext_out["spk"])
        if self.batch_edge:
            return self._push_batch_edge(tick, ext_out)
        tx = ext_out["rtp_tx"]
        # RFC 6464: refresh the audio-level extension from the send-side
        # meter for legs that negotiated it
        if "vol_send.energy" in ext_out:
            energy = ext_out["vol_send.energy"]
            for i, sess in enumerate(self.sessions):
                if sess is not None and getattr(sess, "_level_ext_id", None) is not None:
                    dbov = int(np.clip(-10.0 * np.log10(float(energy[i]) + 1e-12), 0, 127))
                    sess.set_audio_level(dbov, voice=energy[i] > 1e-4)
        if self.features.vad_dtx:
            voice = ext_out["vad.voice"]
        else:
            voice = np.ones(self.batch, bool)
        voice = voice & ~self._rtp_muted
        for i, sess in enumerate(self.sessions):
            if sess is None:
                continue
            if sess.dtmf_active():
                # RFC 4733: telephone-event packets replace the audio for
                # the digit's duration; the RTP clock keeps running
                sess.dtmf_tick(self.S_rtp)
                sess.skip_payload(ts_increment=self.S_rtp)
                continue
            if voice[i] and self._ptime_ticks[i] > 1:
                acc = self._tx_tick_accum[i]
                acc.append(self._encode_payload(tx[i]))
                if len(acc) >= self._ptime_ticks[i]:
                    sess.send_payload(b"".join(acc), ts_increment=self.S_rtp * len(acc))
                    acc.clear()
                continue
            if voice[i]:
                sess.send_payload(self._encode_payload(tx[i]), ts_increment=self.S_rtp)
            elif self._was_voice[i] and self.features.vad_dtx:
                # RFC 3389 CN packet at silence onset
                level = ext_out["vad.floor"][i]
                db = int(np.clip(-10 * np.log10(level + 1e-12), 0, 127))
                old_pt = sess.payload_type
                sess.payload_type = CN_PT
                sess.send_payload(bytes([db]), ts_increment=self.S_rtp)
                sess.payload_type = old_pt
            else:
                sess.skip_payload(ts_increment=self.S_rtp)  # DTX
        self._was_voice = voice.copy()

    # ------------------------------------------------------------------
    def start(self, n_ticks: int = 10 ** 9):
        self.ticker.warm_up()
        self.ticker.start(n_ticks)

    def run(self, n_ticks: int):
        self.ticker.warm_up()
        self.ticker.run(n_ticks)

    def stop(self):
        # RTCP BYE per leg on teardown (rtp_session uninit)
        for sess in self.sessions:
            if sess is not None and sess.rtcp is not None:
                sess.rtcp.send_bye(sess.transport)
        self.ticker.stop()

    # -- RFC 4733 DTMF over RTP -----------------------------------------
    def send_dtmf(self, leg: int, digit: str, duration_ms: int = 100, volume: int = 10):
        """Queue a DTMF digit as telephone-event packets on the leg."""
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        sess.send_dtmf(digit, duration_ms=duration_ms, volume=volume)

    def enable_dtmf_receive(self, leg: int, play_tone: bool = False, tone_ms: int = 100):
        """Deliver inbound telephone-events to ``dtmf_received`` (and, with
        play_tone, regenerate the dual tone into the leg's speaker path
        through dtmf_gen -- needs features.dtmf)."""
        sess = self.sessions[leg]
        if sess is None:
            raise RuntimeError("set_transport first")
        if not hasattr(self, "dtmf_received"):
            self.dtmf_received: List = []

        def on_dtmf(digit, volume, _leg=leg):
            self.dtmf_received.append((_leg, digit))
            if play_tone and self.features.dtmf:
                from mediastreamer2_tpu_torch.ops.tones import dtmf_freqs
                f1, f2 = dtmf_freqs(digit)
                samples = tone_ms * self.rate // 1000

                def trigger(tk):
                    p = tk.params["dtmf"]
                    p["f1"][_leg] = f1
                    p["f2"][_leg] = f2
                    p["remaining"][_leg] = samples
                self.ticker.mutate(trigger)
        sess.on_dtmf = on_dtmf

    def play_announcement(self, signal: np.ndarray, legs: Optional[List[int]] = None):
        """Inject an announcement into the send path of the given legs
        (the audio stream's local player), at the next tick boundary."""
        if "announce" not in self.ticker.state:
            raise RuntimeError("stream built without local_play feature")
        legs = list(range(self.batch)) if legs is None else list(legs)
        sig = torch.from_numpy(np.asarray(signal, np.float32))

        def do_load(tk):
            st = tk.state["announce"]
            data = st["data"]
            if data.shape[1] < len(sig):
                data = torch.zeros((self.batch, len(sig)), dtype=torch.float32,
                                   device=tk.device)
            else:
                data = data.clone()
            idx = torch.tensor(legs, dtype=torch.long, device=tk.device)
            data[idx, :len(sig)] = sig.to(tk.device)
            length, pos = st["length"].clone(), st["pos"].clone()
            length[idx] = len(sig)
            pos[idx] = 0
            tk.state = {**tk.state, "announce": {"data": data, "length": length, "pos": pos}}
        self.ticker.mutate(do_load)

    def enable_rtcp(self, interval_s: float = 5.0):
        """rtcp-mux SR/RR + SDES on every leg with a session, every
        ``interval_s`` (oRTP's RTCP scheduler; emitted from ``iterate``)."""
        for sess in self.sessions:
            if sess is not None and sess.rtcp is None:
                sess.attach_rtcp(interval_s)

    def attach_bitrate_controller(self, leg: int, controller):
        """audio_stream_enable_adaptive_bitrate_control: ``controller``
        (``models/qos.BitrateController``) is fed each remote report."""
        self._brc[leg] = controller

    def attach_quality_indicator(self, leg: int, qi):
        self._qi[leg] = qi

    def attach_bandwidth_controller(self, leg: int, bc):
        """ms_bandwidth_controller_add_stream: the leg's packet-cluster
        bandwidth estimator feeds ``bc`` each ``iterate()`` (enabled here
        if it was not)."""
        self._bwc[leg] = bc
        sess = self.sessions[leg]
        if sess is not None and sess.abe is None:
            sess.enable_audio_bandwidth_estimator()

    def iterate(self):
        """media_stream_iterate (src/voip/mediastream.c:542), the app
        thread's pump: events, the batch edge's playout depth, RTCP
        emission, and the QoS reaction to remote reports and feedback.
        Returns the number of events handled."""
        from mediastreamer2_tpu_torch.models.qos import QosStats
        n = self.ticker.event_queue.pump()
        if getattr(self, "_edge_jitter_ctrl", None) is not None:
            self._edge_jitter_ctrl.control()
        for leg, bc in self._bwc.items():
            sess = self.sessions[leg]
            if sess is None:
                continue
            if sess.abe is not None and sess.abe.measurements:
                bc.update_estimate(sess.abe.available_bw_bps(), kind="audio")
            if sess.vbe is not None and sess.vbe.measurements:
                bc.update_estimate(sess.vbe.available_bw_bps(), kind="video")
        for leg, sess in enumerate(self.sessions):
            if sess is None or sess.rtcp is None:
                continue
            sess.rtcp.maybe_emit(sess.transport)
            if sess.rtcp.remote_reports:
                rb = sess.rtcp.remote_reports[-1]
                stats = QosStats(loss_rate=rb.fraction_lost / 256.0,
                                 rtt_ms=sess.rtcp.last_rtt_ms or 0.0)
                for ctl in (self._brc.get(leg), self._qi.get(leg)):
                    if ctl is not None:
                        ctl.update(stats)
                sess.rtcp.remote_reports.clear()
            # an inbound TMMBR/REMB caps the sender's bitrate
            # (media_stream_process_rtcp, mediastream.c:983-1078)
            for fb in sess.rtcp.feedback_in:
                if fb.kind in ("tmmbr", "remb"):
                    self._apply_bitrate_cap(leg, fb.value)
            sess.rtcp.feedback_in.clear()
        return n

    def _apply_bitrate_cap(self, leg: int, bps: int):
        """Record a TMMBR/REMB cap and tell ``on_tmmbr``. The device codecs
        have fixed rates: only the host codecs (not ported) retarget."""
        self.bitrate_caps[leg] = bps
        if self.on_tmmbr is not None:
            self.on_tmmbr(leg, bps)

    # -- observability ------------------------------------------------------
    def get_stats(self, leg: int):
        sess = self.sessions[leg]
        return None if sess is None else sess.stats

    def print_summary(self) -> str:
        """cf. media_stream_print_summary (mediastream.c:1080)."""
        lines = [f"=== AudioStreamBatch[{self.batch}] codec={self.codec}@{self.rate} ==="]
        t = self.ticker.stats
        lines.append(f"ticker: {t.ticks} ticks, load {t.avg_load:.3f}, "
                     f"late {t.late_ticks}, mean {t.mean_step_ms:.2f} ms")
        for i, sess in enumerate(self.sessions):
            if sess is None:
                continue
            jb = sess.jitter_buffer
            jbs = (f" jb[lost={jb.lost} late={jb.late} underrun={jb.underruns}]"
                   if jb else "")
            lines.append(f"leg {i}: tx {sess.stats.sent_packets} pkts/"
                         f"{sess.stats.sent_bytes}B, rx {sess.stats.recv_packets} pkts{jbs}")
        return "\n".join(lines)

    def alive(self, leg: int, timeout_s: float = 5.0) -> bool:
        """cf. media_stream_alive (mediastream.c:575)."""
        sess = self.sessions[leg]
        return sess is not None and sess.alive(timeout_s)

    def get_recording(self) -> Optional[np.ndarray]:
        if "rec" not in self.ticker.state:
            return None
        from mediastreamer2_tpu_torch.ops.fileio import recorder_get_audio
        self.ticker.sync()
        return recorder_get_audio(self.ticker.state["rec"], self.record_ticks, self.S)
