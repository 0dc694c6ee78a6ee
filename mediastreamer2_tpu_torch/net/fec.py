"""Forward error correction — XOR repair packets (FlexFEC-style, RFC 8627)
(a copy of ``mediastreamer2_tpu/net/fec.py``: plain Python).

Reference: oRTP's FlexFEC ``FecStream`` managed by
``media_stream_create_or_update_fec_session`` (src/voip/mediastream.c:
1229-1268).  Protection schemes over an L x D block of media packets:

* row:    every L consecutive packets -> one repair (recovers 1 loss/row)
* col:    every L-th packet, D deep   -> one repair (recovers 1 loss/col,
          i.e. survives a burst of up to L consecutive losses)
* 2d:     both; the decoder iterates rows<->columns until no progress,
          recovering patterns neither dimension can fix alone.

Repair packets ride their own SSRC/payload type like FlexFEC; the header
carries (base_seq, count, stride, ts_xor) so one format covers rows
(stride=1, count=L) and columns (stride=L, count=D).

Changes from the JAX module, none to the bytes: ``_xor_bytes`` XORs two
packets as two integers instead of byte by byte in Python, and an unknown
scheme raises ``ValueError`` instead of failing an ``assert``.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional

from mediastreamer2_tpu_torch.net.rtp import RtpPacket

FEC_PT = 115
_HDR = struct.Struct("!HHHI")      # base_seq, count, stride, ts_xor


def _xor_bytes(a: bytes, b: bytes) -> bytes:
    """a XOR b, the shorter one padded with zero bytes at its end."""
    if len(a) < len(b):
        a, b = b, a
    n = len(a)
    return (int.from_bytes(a, "big")
            ^ int.from_bytes(b.ljust(n, b"\x00"), "big")).to_bytes(n, "big")


def _protected(pkt: RtpPacket) -> bytes:
    return struct.pack("!H", len(pkt.payload)) + pkt.payload


class FecEncoder:
    """L x D block FEC encoder. push() returns 0..n repair packets."""

    def __init__(self, L: int = 5, D: int = 4, scheme: str = "row",
                 ssrc: int = 0xFEC0FEC0):
        if scheme not in ("row", "col", "2d"):
            raise ValueError(f"FEC scheme {scheme!r}: row, col or 2d")
        self.L, self.D, self.scheme = L, D, scheme
        self.ssrc = ssrc
        self.repair_seq = 0
        self._block: List[RtpPacket] = []
        self._base_seq: Optional[int] = None

    def _repair(self, pkts: List[RtpPacket], base_seq: int,
                stride: int) -> RtpPacket:
        acc = _protected(pkts[0])
        ts = pkts[0].timestamp
        for p in pkts[1:]:
            acc = _xor_bytes(acc, _protected(p))
            ts ^= p.timestamp
        hdr = _HDR.pack(base_seq, len(pkts), stride, ts & 0xFFFFFFFF)
        rp = RtpPacket(FEC_PT, self.repair_seq, 0, self.ssrc, hdr + acc)
        self.repair_seq = (self.repair_seq + 1) & 0xFFFF
        return rp

    def push(self, pkt: RtpPacket) -> List[RtpPacket]:
        """Feed a media packet; returns repair packets as rows/cols close."""
        if self._base_seq is None:
            self._base_seq = pkt.seq
        self._block.append(pkt)
        out: List[RtpPacket] = []
        n = len(self._block)
        L, D = self.L, self.D
        if self.scheme in ("row", "2d") and n % L == 0:
            row = self._block[n - L: n]
            out.append(self._repair(row, row[0].seq, 1))
        block_size = L * D if self.scheme != "row" else L
        if n >= block_size:
            if self.scheme in ("col", "2d"):
                for c in range(L):
                    col = [self._block[r * L + c] for r in range(D)]
                    out.append(self._repair(col, col[0].seq, L))
            self._block = []
            self._base_seq = None
        return out


class FecDecoder:
    """Buffers media + repair packets; iterative row/column recovery."""

    def __init__(self, history: int = 256):
        self.media: Dict[int, RtpPacket] = {}
        self.history = history
        self.pending: List[bytes] = []     # repairs that couldn't fire yet
        self.recovered = 0
        self.unrecoverable = 0

    def push_media(self, pkt: RtpPacket):
        self.media[pkt.seq] = pkt
        if len(self.media) > self.history:
            for s in sorted(self.media)[: len(self.media) - self.history]:
                del self.media[s]

    def _try(self, payload: bytes) -> Optional[RtpPacket]:
        base_seq, count, stride, ts_xor = _HDR.unpack_from(payload)
        acc = payload[_HDR.size:]
        missing = []
        for k in range(count):
            seq = (base_seq + k * stride) & 0xFFFF
            pkt = self.media.get(seq)
            if pkt is None:
                missing.append(seq)
            else:
                acc = _xor_bytes(acc, _protected(pkt))
                ts_xor ^= pkt.timestamp
        if not missing or len(missing) > 1:
            return None
        ln = struct.unpack("!H", acc[:2])[0]
        if ln > len(acc) - 2:
            return None
        rec = RtpPacket(payload_type=0, seq=missing[0],
                        timestamp=ts_xor & 0xFFFFFFFF, ssrc=0,
                        payload=acc[2:2 + ln])
        self.media[rec.seq] = rec
        self.recovered += 1
        return rec

    def push_repair(self, repair: RtpPacket) -> List[RtpPacket]:
        """Returns newly reconstructed media packets (possibly several:
        one recovery can unblock pending repairs in the other dimension)."""
        out: List[RtpPacket] = []
        rec = self._try(repair.payload)
        if rec is None:
            self.pending.append(repair.payload)
            if len(self.pending) > 64:
                self.pending.pop(0)
                self.unrecoverable += 1
            return out
        out.append(rec)
        # iterate: a recovered packet may complete other rows/columns
        progress = True
        while progress:
            progress = False
            for payload in list(self.pending):
                rec = self._try(payload)
                if rec is not None:
                    self.pending.remove(payload)
                    out.append(rec)
                    progress = True
        return out
