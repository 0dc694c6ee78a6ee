"""H.264/H.265 NAL packetization — RFC 6184 / RFC 7798 byte plumbing (a copy of
``mediastreamer2_tpu/net/h26x.py``: plain Python).

Reference: the h26x/ subsystem (src/videofilters/h26x/: NAL packer/unpacker
templates, parameter-set stores; tested by
tester/mediastreamer2_h26x_tools_tester.cpp against raw fixtures).  Pure
byte work — host side.  Codec backends (x264/MediaCodec/VideoToolbox in the
reference) plug in separately; the packetization layer here is
codec-agnostic and covers: Annex B stream <-> NAL units, single-NAL mode,
FU-A fragmentation, STAP-A aggregation, and a parameter-set store that
replays SPS/PPS ahead of IDR frames.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

NAL_STAP_A = 24
NAL_FU_A = 28
NAL_SPS = 7
NAL_PPS = 8
NAL_IDR = 5


def split_annexb(stream: bytes) -> List[bytes]:
    """Annex B (00 00 01 / 00 00 00 01 start codes) -> NAL units."""
    # locate start codes: (sc_begin, payload_begin) pairs
    marks: List[Tuple[int, int]] = []
    i = 0
    n = len(stream)
    while i + 2 < n:
        if stream[i] == 0 and stream[i + 1] == 0 and stream[i + 2] == 1:
            sc_begin = i - 1 if (i > 0 and stream[i - 1] == 0) else i
            marks.append((sc_begin, i + 3))
            i += 3
        else:
            i += 1
    nals = []
    for k, (_, begin) in enumerate(marks):
        end = marks[k + 1][0] if k + 1 < len(marks) else n
        if end > begin:
            nals.append(stream[begin:end])
    return nals


def to_annexb(nals: List[bytes]) -> bytes:
    return b"".join(b"\x00\x00\x00\x01" + n for n in nals)


def nal_type(nal: bytes) -> int:
    return nal[0] & 0x1F if nal else 0


def packetize(nals: List[bytes], mtu: int = 1400,
              aggregate: bool = True) -> List[bytes]:
    """NAL units -> RTP payloads (single NAL / STAP-A / FU-A)."""
    payloads: List[bytes] = []
    pending_stap: List[bytes] = []

    def flush_stap():
        nonlocal pending_stap
        if not pending_stap:
            return
        if len(pending_stap) == 1:
            payloads.append(pending_stap[0])
        else:
            f = max(n[0] & 0x80 for n in pending_stap)
            nri = max(n[0] & 0x60 for n in pending_stap)
            body = b"".join(struct.pack("!H", len(n)) + n
                            for n in pending_stap)
            payloads.append(bytes([f | nri | NAL_STAP_A]) + body)
        pending_stap = []

    for nal in nals:
        if len(nal) <= mtu:
            if aggregate:
                agg_size = (sum(len(n) + 2 for n in pending_stap)
                            + len(nal) + 2 + 1)
                if pending_stap and agg_size > mtu:
                    flush_stap()
                pending_stap.append(nal)
                # aggregate only small non-VCL-ish units; flush big ones
                if len(nal) > mtu // 4:
                    flush_stap()
            else:
                payloads.append(nal)
            continue
        flush_stap()
        # FU-A fragmentation
        hdr = nal[0]
        fu_indicator = (hdr & 0xE0) | NAL_FU_A
        body = nal[1:]
        chunk = mtu - 2
        for k in range(0, len(body), chunk):
            part = body[k:k + chunk]
            fu_header = (hdr & 0x1F) \
                | (0x80 if k == 0 else 0) \
                | (0x40 if k + chunk >= len(body) else 0)
            payloads.append(bytes([fu_indicator, fu_header]) + part)
    flush_stap()
    return payloads


class H264Unpacker:
    """RTP payloads -> NAL units (handles single NAL, STAP-A, FU-A)."""

    def __init__(self):
        self._fu: Optional[bytearray] = None
        self.errors = 0

    def push(self, payload: bytes) -> List[bytes]:
        if not payload:
            return []
        t = payload[0] & 0x1F
        if t == NAL_STAP_A:
            nals = []
            off = 1
            while off + 2 <= len(payload):
                ln = struct.unpack_from("!H", payload, off)[0]
                off += 2
                nals.append(payload[off:off + ln])
                off += ln
            return nals
        if t == NAL_FU_A:
            if len(payload) < 2:
                self.errors += 1
                return []
            fu_header = payload[1]
            start, end = fu_header & 0x80, fu_header & 0x40
            if start:
                hdr = (payload[0] & 0xE0) | (fu_header & 0x1F)
                self._fu = bytearray([hdr]) + payload[2:]
                return []
            if self._fu is None:
                self.errors += 1
                return []
            self._fu += payload[2:]
            if end:
                nal, self._fu = bytes(self._fu), None
                return [nal]
            return []
        return [payload]          # single NAL


class ParameterSetStore:
    """Keeps the latest SPS/PPS and replays them ahead of IDR frames
    (cf. h26x parameter-set store: decoders joining mid-stream need them)."""

    def __init__(self):
        self.sps: Optional[bytes] = None
        self.pps: Optional[bytes] = None

    def process(self, nal: bytes):
        t = nal_type(nal)
        if t == NAL_SPS:
            self.sps = nal
        elif t == NAL_PPS:
            self.pps = nal

    def prepend_for_idr(self, nals: List[bytes]) -> List[bytes]:
        if any(nal_type(n) == NAL_IDR for n in nals) \
                and not any(nal_type(n) == NAL_SPS for n in nals) \
                and self.sps and self.pps:
            return [self.sps, self.pps] + nals
        return nals

    @property
    def ready(self) -> bool:
        return self.sps is not None and self.pps is not None


# ---------------------------------------------------------------------------
# H.265 / HEVC payloads (RFC 7798) — the other half of the reference's h26x
# framework (src/videofilters/h26x/: shared NAL pack/unpack templates with
# per-codec NAL-header rules; raw fixtures at tester/raw/h265-*).
# ---------------------------------------------------------------------------
H265_AP = 48                 # aggregation packet
H265_FU = 49                 # fragmentation unit
H265_VPS, H265_SPS, H265_PPS = 32, 33, 34


def h265_nal_type(nal: bytes) -> int:
    return (nal[0] >> 1) & 0x3F if nal else -1


def h265_is_irap(nal: bytes) -> bool:
    """IRAP (IDR/CRA/BLA) NAL types 16..21 — random access points."""
    return 16 <= h265_nal_type(nal) <= 21


def h265_packetize(nals: List[bytes], mtu: int = 1400) -> List[bytes]:
    """NAL units -> RTP payloads (single NAL / AP / FU per RFC 7798)."""
    payloads: List[bytes] = []
    pending: List[bytes] = []

    def layer_tid(ns):
        # AP header carries min LayerId and min TID of the aggregated units
        lid = min(((n[0] & 1) << 5) | (n[1] >> 3) for n in ns)
        tid = min(n[1] & 0x07 for n in ns)
        return lid, tid

    def flush_ap():
        nonlocal pending
        if not pending:
            return
        if len(pending) == 1:
            payloads.append(pending[0])
        else:
            f = max(n[0] & 0x80 for n in pending)
            lid, tid = layer_tid(pending)
            hdr = bytes([f | (H265_AP << 1) | (lid >> 5),
                         ((lid & 0x1F) << 3) | tid])
            body = b"".join(struct.pack("!H", len(n)) + n for n in pending)
            payloads.append(hdr + body)
        pending = []

    for nal in nals:
        if len(nal) <= mtu:
            agg = sum(len(n) + 2 for n in pending) + len(nal) + 2 + 2
            if pending and agg > mtu:
                flush_ap()
            pending.append(nal)
            if len(nal) > mtu // 4:
                flush_ap()
            continue
        flush_ap()
        # FU: PayloadHdr(type=49) + FU header(S|E|FuType) + fragment
        ph = bytes([(nal[0] & 0x81) | (H265_FU << 1), nal[1]])
        fu_type = h265_nal_type(nal)
        body = nal[2:]
        chunk = mtu - 3
        for k in range(0, len(body), chunk):
            s = 0x80 if k == 0 else 0
            e = 0x40 if k + chunk >= len(body) else 0
            payloads.append(ph + bytes([s | e | fu_type]) + body[k:k + chunk])
    flush_ap()
    return payloads


class H265Unpacker:
    """RTP payloads -> H.265 NAL units (single / AP / FU)."""

    def __init__(self):
        self._fu: Optional[bytearray] = None
        self.errors = 0

    def push(self, payload: bytes) -> List[bytes]:
        if len(payload) < 2:
            return []
        t = (payload[0] >> 1) & 0x3F
        if t == H265_AP:
            nals = []
            off = 2
            while off + 2 <= len(payload):
                ln = struct.unpack_from("!H", payload, off)[0]
                off += 2
                nals.append(payload[off:off + ln])
                off += ln
            return nals
        if t == H265_FU:
            if len(payload) < 3:
                self.errors += 1
                return []
            fu = payload[2]
            start, end = fu & 0x80, fu & 0x40
            if start:
                hdr0 = (payload[0] & 0x81) | ((fu & 0x3F) << 1)
                self._fu = bytearray([hdr0, payload[1]]) + payload[3:]
                if not end:
                    return []
            elif self._fu is None:
                self.errors += 1
                return []
            else:
                self._fu += payload[3:]
            if end and self._fu is not None:
                nal, self._fu = bytes(self._fu), None
                return [nal]
            return []
        return [payload]


class H265ParameterSetStore:
    """VPS/SPS/PPS store, replayed ahead of IRAP frames (the HEVC half of
    the h26x parameter-set store)."""

    def __init__(self):
        self.vps: Optional[bytes] = None
        self.sps: Optional[bytes] = None
        self.pps: Optional[bytes] = None

    def process(self, nal: bytes):
        t = h265_nal_type(nal)
        if t == H265_VPS:
            self.vps = nal
        elif t == H265_SPS:
            self.sps = nal
        elif t == H265_PPS:
            self.pps = nal

    @property
    def ready(self) -> bool:
        return None not in (self.vps, self.sps, self.pps)

    def prepend_for_irap(self, nals: List[bytes]) -> List[bytes]:
        if any(h265_is_irap(n) for n in nals) \
                and not any(h265_nal_type(n) == H265_SPS for n in nals) \
                and self.ready:
            return [self.vps, self.sps, self.pps] + nals
        return nals


# ---------------------------------------------------------------------------
# H.263 payloads (RFC 4629) — transport for the legacy codec family
# (reference: videoenc.c's RFC2190/4629 packing glue).
# ---------------------------------------------------------------------------
def h263_packetize(frame: bytes, mtu: int = 1400) -> List[bytes]:
    """One encoded H.263 frame -> RTP payloads.

    First payload starts at the picture start code with P=1 (the two zero
    bytes of the PSC are elided per RFC 4629 §5.1); continuations carry
    P=0 with the full bytes."""
    payloads: List[bytes] = []
    first = frame.startswith(b"\x00\x00")
    off = 2 if first else 0
    chunk = mtu - 2
    pos = off
    while pos < len(frame) or not payloads:
        part = frame[pos:pos + chunk]
        pos += len(part)
        p_bit = 0x04 if first and len(payloads) == 0 else 0x00
        payloads.append(bytes([p_bit, 0x00]) + part)
    return payloads


class H263Depacketizer:
    """RTP payloads -> frames (marker bit closes the picture)."""

    def __init__(self):
        self._acc = bytearray()
        self.completed: List[bytes] = []
        self.errors = 0

    def push(self, payload: bytes, marker: bool):
        if len(payload) < 2:
            self.errors += 1
            return
        p_bit = payload[0] & 0x04
        body = payload[2:]
        if p_bit:
            self._acc += b"\x00\x00"     # restore the elided PSC zeros
        self._acc += body
        if marker:
            self.completed.append(bytes(self._acc))
            self._acc = bytearray()

    def pop(self):
        return self.completed.pop(0) if self.completed else None
