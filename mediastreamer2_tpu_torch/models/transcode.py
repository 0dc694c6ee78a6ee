"""RTP-as-IO transcoding legs (port of ``mediastreamer2_tpu/models/transcode.py``;
the reference's audio_stream_start_from_io, src/voip/audiostream.c:1347-1384:
a stream whose "soundcard" ends are other RTP sessions, the shape B2BUA and
gateway transcoders use, also the conference endpoint's transfer mode).

TranscodeBatch: N legs, each decoding codec A from one RTP session and
re-encoding codec B (with resampling when the rates differ) to another,
one device program for all legs:

    rx(codec_a @ rate_a) -> decode -> [resample] -> encode -> tx(codec_b)

Payloads, as in the JAX package: one byte per code for ulaw, alaw and
g722; big-endian 16-bit per code otherwise (l16 samples, G.726 codes).
The codecs are those of ``PAYLOAD_TYPES`` that have device filters: ulaw,
alaw, l16, g722 and g726_32. ``device=None`` runs on ``cuda`` (raising
without a card); tests pass ``"cpu"``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from mediastreamer2_tpu_torch.core.block import Format, tick_samples
from mediastreamer2_tpu_torch.core.graph import GraphBuilder
from mediastreamer2_tpu_torch.core.ticker import Ticker
from mediastreamer2_tpu_torch.models.audio_stream import (CODEC_BYTES_PER_SAMPLE,
                                                          PAYLOAD_TYPES, RTP_CLOCK)
from mediastreamer2_tpu_torch.net.jitter import JBParams, JitterBuffer
from mediastreamer2_tpu_torch.net.rtp import RtpSession, Transport


class TranscodeBatch:
    """N transcoding legs (device codecs only: ulaw/alaw/l16/g722/g726_32)."""

    def __init__(self, factory, batch: int, codec_in: str = "ulaw",
                 rate_in: int = 8000, codec_out: str = "g722",
                 rate_out: int = 16000, device=None):
        self.batch = batch
        self.codec_in, self.codec_out = codec_in, codec_out
        self.rate_in, self.rate_out = rate_in, rate_out
        self.clock_in = RTP_CLOCK.get(codec_in, rate_in)
        self.clock_out = RTP_CLOCK.get(codec_out, rate_out)
        self.S_in = tick_samples(self.clock_in)
        self.S_out = tick_samples(self.clock_out)

        g = GraphBuilder(factory, batch=batch)
        rx = g.add("ext_source", "rx", fmt=Format(kind=codec_in, rate=self.clock_in))
        dec = g.add(f"{codec_in}_dec", "dec")
        g.link(rx, 0, dec, 0)
        last = dec
        if rate_in != rate_out:
            rs = g.add("resample", "rs", out_rate=rate_out)
            g.link(last, 0, rs, 0)
            last = rs
        enc = g.add(f"{codec_out}_enc", "enc")
        g.link(last, 0, enc, 0)
        g.link(enc, 0, g.add("ext_sink", "tx"), 0)
        self.graph = g.build()
        self.ticker = Ticker(self.graph, device=device, name=f"transcode[{batch}]")
        self.device = self.ticker.device
        self.ticker.set_io(pull=self._pull, push=self._push)

        self.rx_sessions: List[Optional[RtpSession]] = [None] * batch
        self.tx_sessions: List[Optional[RtpSession]] = [None] * batch

    def set_transports(self, leg: int, rx: Transport, tx: Transport):
        self.rx_sessions[leg] = RtpSession(
            rx, payload_type=PAYLOAD_TYPES[self.codec_in],
            clock_rate=self.clock_in, jitter_buffer=JitterBuffer(JBParams()))
        self.tx_sessions[leg] = RtpSession(
            tx, payload_type=PAYLOAD_TYPES[self.codec_out],
            clock_rate=self.clock_out)

    def _decode(self, payload: bytes) -> np.ndarray:
        if self.codec_in in ("ulaw", "alaw", "g722"):
            return np.frombuffer(payload, np.uint8).astype(np.int32)
        return np.frombuffer(payload, ">i2").astype(np.int32)

    def _encode(self, row: np.ndarray) -> bytes:
        if self.codec_out in ("ulaw", "alaw", "g722"):
            return row.astype(np.uint8).tobytes()
        return row.astype(">i2").tobytes()

    def _pull(self, tick: int):
        B = self.batch
        rx = np.zeros((B, self.S_in), np.int32)
        need = self.S_in * CODEC_BYTES_PER_SAMPLE.get(self.codec_in, 2)
        for i, sess in enumerate(self.rx_sessions):
            if sess is None:
                continue
            sess.poll()
            payload = sess.jitter_buffer.get_tick()
            if payload is not None and len(payload) == need:
                rx[i] = self._decode(payload)
        return {"rx": rx}

    def _push(self, tick: int, ext_out):
        tx = ext_out["tx"]
        for i, sess in enumerate(self.tx_sessions):
            if sess is not None:
                sess.send_payload(self._encode(tx[i]), ts_increment=self.S_out)

    def run(self, n_ticks: int):
        self.ticker.warm_up()
        self.ticker.run(n_ticks)
