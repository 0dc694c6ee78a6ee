"""Real-time text (RFC 4103): T.140 over RTP with redundancy (RED, RFC 2198)
(a copy of ``mediastreamer2_tpu/net/rtt.py``: plain Python, over the
port's ``net/rtp.RtpSession``).

Reference: src/otherfilters/rfc4103_source.c / rfc4103_sink.c and
src/voip/rfc4103_textstream.c (graph rttsource->rtpsend, rtprecv->rttsink).
Pure byte plumbing — host side by design (no DSP).

Send: characters are buffered and emitted at most every 300 ms (T.140
buffering time) with up to 2 redundant generations so single losses never
lose text.  Recv: RED generations reconstruct missed primaries; sequence
gaps beyond redundancy surface the T.140 loss marker (U+FFFD).
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

T140_PT = 98          # dynamic payload type for t140
RED_PT = 99           # dynamic payload type for red-wrapped t140
BUFFER_MS = 300       # T.140 recommended buffering
MAX_RED_GEN = 2
LOSS_CHAR = "�"


class RttSource:
    """Outgoing side: collect chars, build RED payloads each flush."""

    def __init__(self, use_red: bool = True):
        self.use_red = use_red
        self.pending = ""
        self.generations: List[bytes] = []       # previous payloads (newest first)
        self.last_flush_ms = 0

    def put_char(self, ch: str):
        self.pending += ch

    def put_text(self, text: str):
        self.pending += text

    def flush(self, now_ms: int) -> Optional[Tuple[int, bytes]]:
        """Returns (payload_type, payload) when it's time to send."""
        if now_ms - self.last_flush_ms < BUFFER_MS:
            return None
        primary = self.pending.encode("utf-8")
        if not primary and not any(self.generations):
            return None                            # nothing to send or protect
        self.pending = ""
        self.last_flush_ms = now_ms
        if not self.use_red:
            self.generations = [primary]
            return (T140_PT, primary)
        gens = self.generations[:MAX_RED_GEN]      # newest first
        # RED: headers for redundant blocks (oldest first), then primary
        blocks = list(reversed(gens))
        hdr = b""
        body = b""
        ts_off = BUFFER_MS * len(blocks)
        for blk in blocks:
            hdr += struct.pack("!BHB",
                               0x80 | T140_PT,
                               ((ts_off & 0x3FFF) << 2) | (len(blk) >> 8),
                               len(blk) & 0xFF)
            body += blk
            ts_off -= BUFFER_MS
        hdr += struct.pack("!B", T140_PT)          # final header: primary
        self.generations = [primary] + gens
        return (RED_PT, hdr + body + primary)


class RttSink:
    """Incoming side: reassemble text, recover via RED, flag losses."""

    def __init__(self):
        self.received = ""
        self.next_seq: Optional[int] = None
        self.lost_events = 0

    def on_packet(self, seq: int, payload_type: int, payload: bytes):
        missed = 0
        if self.next_seq is not None:
            missed = (seq - self.next_seq) & 0xFFFF
            if missed >= 0x8000:                   # old duplicate
                return
        self.next_seq = (seq + 1) & 0xFFFF

        if payload_type == T140_PT:
            if missed:
                self.lost_events += missed
                self.received += LOSS_CHAR * min(missed, 1)
            self.received += payload.decode("utf-8", errors="replace")
            return

        # RED: parse headers
        blocks = []
        off = 0
        while off < len(payload):
            b0 = payload[off]
            if b0 & 0x80:
                _, mid, blen = struct.unpack_from("!BHB", payload, off)
                blocks.append((mid >> 2, ((mid & 0x3) << 8) | blen))
                off += 4
            else:
                off += 1
                break
        datas = []
        for _, blen in blocks:
            datas.append(payload[off: off + blen])
            off += blen
        primary = payload[off:]
        # use redundancy to cover `missed` packets (newest redundant block
        # covers the most recent miss)
        if missed:
            usable = list(reversed(datas))[:missed]     # newest first
            if missed > len(usable):
                self.lost_events += missed - len(usable)
                self.received += LOSS_CHAR
            for blk in reversed(usable):
                self.received += blk.decode("utf-8", errors="replace")
        self.received += primary.decode("utf-8", errors="replace")


class TextStream:
    """Session-level duplex RTT leg over an RtpSession-like transport
    (parity: rfc4103_textstream.c)."""

    def __init__(self, rtp_session, use_red: bool = True):
        self.rtp = rtp_session
        self.rtp.payload_type = RED_PT if use_red else T140_PT
        self.rtp.accepted_payload_types = {T140_PT, RED_PT}
        self.source = RttSource(use_red)
        self.sink = RttSink()
        self.rtp.on_packet = self._on_rtp
        self.rtp.jitter_buffer = None              # text is not tick-paced

    def put_char(self, ch: str):
        self.source.put_char(ch)

    def iterate(self, now_ms: int):
        self.rtp.poll()
        out = self.source.flush(now_ms)
        if out is not None:
            pt, payload = out
            old_pt = self.rtp.payload_type
            self.rtp.payload_type = pt
            self.rtp.send_payload(payload, ts_increment=BUFFER_MS * 8)
            self.rtp.payload_type = old_pt

    def _on_rtp(self, pkt):
        self.sink.on_packet(pkt.seq, pkt.payload_type, pkt.payload)

    def get_received_text(self) -> str:
        return self.sink.received
