"""RTCP (RFC 3550): sender and receiver reports, SDES, BYE, AVPF feedback
and XR blocks, host side (a copy of ``mediastreamer2_tpu/net/rtcp.py``:
plain Python).

Reference: RTCP lives in oRTP (SR/RR/SDES/XR + feedback TMMBR/REMB/FIR/PLI
/NACK), consumed by mediastreamer2's QoS layer via
``media_stream_process_rtcp`` (src/voip/mediastream.c:983-1078).

SR/RR pack and unpack with interval statistics (fraction lost, cumulative
lost, jitter, LSR/DLSR for the round-trip time), the RFC 4585 feedback set
(TMMBR/REMB bitrate caps, PLI/SLI/RPSI/FIR picture requests, NACK) and RFC
3611 XR blocks; wire format as RFC 3550, so captures interoperate.
``RtcpSession`` emits a compound SR + SDES every interval and collects the
remote reports and feedback that the QoS layer reads.
"""
from __future__ import annotations

import dataclasses
import struct
import time
from typing import List, Optional, Tuple

RTCP_SR = 200
RTCP_RR = 201
RTCP_SDES = 202
RTCP_BYE = 203
RTCP_RTPFB = 205     # transport feedback (TMMBR, NACK)
RTCP_PSFB = 206      # payload-specific (PLI, FIR, REMB)
RTCP_XR = 207        # extended reports (RFC 3611)

XR_BLOCK_RCVR_RTT = 4         # receiver reference time
XR_BLOCK_VOIP_METRICS = 7     # VoIP metrics (used by qualityindicator)
SDES_CNAME = 1
SDES_TOOL = 6

FMT_NACK = 1
FMT_TMMBR = 3
FMT_PLI = 1
FMT_SLI = 2
FMT_RPSI = 3
FMT_FIR = 4
FMT_REMB = 15


def ntp_now() -> Tuple[int, int]:
    t = time.time() + 2208988800.0
    sec = int(t)
    frac = int((t - sec) * (1 << 32)) & 0xFFFFFFFF
    return sec & 0xFFFFFFFF, frac


@dataclasses.dataclass
class ReportBlock:
    ssrc: int
    fraction_lost: int       # 0..255
    cumulative_lost: int
    highest_seq: int
    jitter: int
    lsr: int
    dlsr: int

    def pack(self) -> bytes:
        cl = self.cumulative_lost & 0xFFFFFF
        return struct.pack("!IIIIII", self.ssrc,
                           ((self.fraction_lost & 0xFF) << 24) | cl,
                           self.highest_seq, self.jitter, self.lsr, self.dlsr)

    @classmethod
    def unpack(cls, data: bytes) -> "ReportBlock":
        ssrc, fl_cl, hs, j, lsr, dlsr = struct.unpack("!IIIIII", data[:24])
        return cls(ssrc, fl_cl >> 24, fl_cl & 0xFFFFFF, hs, j, lsr, dlsr)


@dataclasses.dataclass
class SenderReport:
    ssrc: int
    ntp_sec: int
    ntp_frac: int
    rtp_ts: int
    packet_count: int
    octet_count: int
    reports: List[ReportBlock]

    def pack(self) -> bytes:
        body = struct.pack("!IIIIII", self.ssrc, self.ntp_sec, self.ntp_frac,
                           self.rtp_ts, self.packet_count, self.octet_count)
        body += b"".join(r.pack() for r in self.reports)
        hdr = struct.pack("!BBH", 0x80 | len(self.reports), RTCP_SR,
                          len(body) // 4)
        return hdr + body


@dataclasses.dataclass
class ReceiverReport:
    ssrc: int
    reports: List[ReportBlock]

    def pack(self) -> bytes:
        body = struct.pack("!I", self.ssrc)
        body += b"".join(r.pack() for r in self.reports)
        hdr = struct.pack("!BBH", 0x80 | len(self.reports), RTCP_RR,
                          len(body) // 4)
        return hdr + body


def sli_value(first: int, number: int, picture_id: int) -> int:
    """Pack an SLI FCI word (RFC 4585 §6.3.2: First|Number|PictureID)."""
    return ((first & 0x1FFF) << 19) | ((number & 0x1FFF) << 6) \
        | (picture_id & 0x3F)


@dataclasses.dataclass
class Feedback:
    """RTPFB/PSFB message (TMMBR / REMB / PLI / SLI / RPSI / FIR / NACK) —
    the AVPF set the reference's video streams emit
    (videostream.c:2076-2100)."""
    kind: str        # 'tmmbr' | 'remb' | 'pli' | 'sli' | 'rpsi' | 'fir' | 'nack'
    sender_ssrc: int
    media_ssrc: int
    value: int = 0           # bps (tmmbr/remb), seq (nack/fir), sli word,
    #                          rpsi payload type
    data: bytes = b""        # rpsi: native bitstring (e.g. VP8 picture id)

    def pack(self) -> bytes:
        if self.kind == "pli":
            pt, fmt, fci = RTCP_PSFB, FMT_PLI, b""
        elif self.kind == "sli":
            pt, fmt = RTCP_PSFB, FMT_SLI
            fci = struct.pack("!I", self.value)
        elif self.kind == "rpsi":
            # RFC 4585 §6.3.3: PB padding bits | 0+PT | bitstring, 32-b align
            pt, fmt = RTCP_PSFB, FMT_RPSI
            bits = self.data
            pad = (4 - (2 + len(bits)) % 4) % 4
            fci = bytes([pad * 8, self.value & 0x7F]) + bits + b"\x00" * pad
        elif self.kind == "fir":
            pt, fmt = RTCP_PSFB, FMT_FIR
            fci = struct.pack("!IBxxx", self.media_ssrc, self.value & 0xFF)
        elif self.kind == "tmmbr":
            pt, fmt = RTCP_RTPFB, FMT_TMMBR
            exp, mant = _mantissa_exp(self.value)
            fci = struct.pack("!II", self.media_ssrc,
                              (exp << 26) | (mant << 9))
        elif self.kind == "remb":
            pt, fmt = RTCP_PSFB, FMT_REMB
            exp, mant = _mantissa_exp(self.value, mant_bits=18)
            fci = (b"REMB" + struct.pack("!BBH", 1, exp << 2 | mant >> 16,
                                         mant & 0xFFFF)
                   + struct.pack("!I", self.media_ssrc))
        elif self.kind == "nack":
            pt, fmt = RTCP_RTPFB, FMT_NACK
            fci = struct.pack("!HH", self.value & 0xFFFF, 0)
        else:
            raise ValueError(self.kind)
        body = struct.pack("!II", self.sender_ssrc, self.media_ssrc) + fci
        hdr = struct.pack("!BBH", 0x80 | fmt, pt, len(body) // 4)
        return hdr + body


def _mantissa_exp(bps: int, mant_bits: int = 17) -> Tuple[int, int]:
    exp = 0
    while bps >= (1 << mant_bits):
        bps >>= 1
        exp += 1
    return exp, bps


@dataclasses.dataclass
class Sdes:
    ssrc: int
    cname: str = ""
    tool: str = ""

    def pack(self) -> bytes:
        items = b""
        if self.cname:
            c = self.cname.encode()
            items += bytes([SDES_CNAME, len(c)]) + c
        if self.tool:
            t = self.tool.encode()
            items += bytes([SDES_TOOL, len(t)]) + t
        items += b"\x00"
        items += b"\x00" * ((4 - len(items) % 4) % 4)
        body = struct.pack("!I", self.ssrc) + items
        hdr = struct.pack("!BBH", 0x80 | 1, RTCP_SDES, len(body) // 4)
        return hdr + body


@dataclasses.dataclass
class XrVoipMetrics:
    """RFC 3611 §4.7 VoIP metrics block (the qualityindicator's input —
    reference computes MOS from these, src/voip/qualityindicator.c)."""
    ssrc: int
    loss_rate: int = 0          # fraction * 256
    discard_rate: int = 0
    burst_density: int = 0
    gap_density: int = 0
    burst_duration_ms: int = 0
    gap_duration_ms: int = 0
    round_trip_delay_ms: int = 0
    end_system_delay_ms: int = 0
    signal_level: int = 127     # dBm (127 = unavailable)
    noise_level: int = 127
    rerl: int = 127
    r_factor: int = 127         # 127 = unavailable
    mos_lq: int = 127           # MOS * 10 (10..50), 127 unavailable
    mos_cq: int = 127
    jb_nominal_ms: int = 0
    jb_max_ms: int = 0

    def pack(self) -> bytes:
        blk = struct.pack("!BBH", XR_BLOCK_VOIP_METRICS, 0, 8)
        blk += struct.pack("!I", self.ssrc)
        blk += struct.pack("!BBBB", self.loss_rate & 0xFF,
                           self.discard_rate & 0xFF,
                           self.burst_density & 0xFF,
                           self.gap_density & 0xFF)
        blk += struct.pack("!HH", self.burst_duration_ms,
                           self.gap_duration_ms)
        blk += struct.pack("!HH", self.round_trip_delay_ms,
                           self.end_system_delay_ms)
        blk += struct.pack("!BBBB", self.signal_level & 0xFF,
                           self.noise_level & 0xFF, self.rerl, 0)
        blk += struct.pack("!BBBB", self.r_factor, 127,
                           self.mos_lq, self.mos_cq)
        blk += struct.pack("!BBH", 0, 0, 0)          # rx config + reserved
        blk += struct.pack("!HH", self.jb_nominal_ms, self.jb_max_ms)
        return blk

    @classmethod
    def unpack(cls, blk: bytes) -> "XrVoipMetrics":
        ssrc = struct.unpack_from("!I", blk, 4)[0]
        lr, dr, bd, gd = struct.unpack_from("!BBBB", blk, 8)
        bdur, gdur = struct.unpack_from("!HH", blk, 12)
        rtd, esd = struct.unpack_from("!HH", blk, 16)
        sl, nl, rerl, _ = struct.unpack_from("!BBBB", blk, 20)
        rf, _, mlq, mcq = struct.unpack_from("!BBBB", blk, 24)
        jbn, jbm = struct.unpack_from("!HH", blk, 32)
        return cls(ssrc, lr, dr, bd, gd, bdur, gdur, rtd, esd, sl, nl,
                   rerl, rf, mlq, mcq, jbn, jbm)


@dataclasses.dataclass
class XrReceiverReferenceTime:
    """RFC 3611 §4.4 (block 4): receiver NTP timestamp — lets a media
    SENDER-less endpoint still be an RTT anchor (paired with DLRR)."""
    ntp: int    # 64-bit NTP timestamp

    def pack(self) -> bytes:
        return struct.pack("!BBHQ", XR_BLOCK_RCVR_RTT, 0, 2, self.ntp)

    @classmethod
    def unpack(cls, blk: bytes) -> "XrReceiverReferenceTime":
        return cls(struct.unpack_from("!Q", blk, 4)[0])


@dataclasses.dataclass
class XrDlrr:
    """RFC 3611 §4.5 (block 5): delay since last RR, one sub-block per
    reported SSRC: (ssrc, last_rr middle-32 NTP, delay in 1/65536 s)."""
    subblocks: List[Tuple[int, int, int]]

    def pack(self) -> bytes:
        body = b"".join(struct.pack("!III", s, lrr, dlrr)
                        for s, lrr, dlrr in self.subblocks)
        return struct.pack("!BBH", 5, 0, len(body) // 4) + body

    @classmethod
    def unpack(cls, blk: bytes) -> "XrDlrr":
        subs = []
        for o in range(4, len(blk) - 11, 12):
            subs.append(struct.unpack_from("!III", blk, o))
        return cls(subs)


@dataclasses.dataclass
class XrStatSummary:
    """RFC 3611 §4.6 (block 6): per-interval loss/dup/jitter summary."""
    ssrc: int
    begin_seq: int
    end_seq: int
    lost: int = 0
    dup: int = 0
    min_jitter: int = 0
    max_jitter: int = 0
    mean_jitter: int = 0
    dev_jitter: int = 0

    def pack(self) -> bytes:
        body = struct.pack("!IHHIIIIII", self.ssrc, self.begin_seq,
                           self.end_seq, self.lost, self.dup,
                           self.min_jitter, self.max_jitter,
                           self.mean_jitter, self.dev_jitter)
        body += struct.pack("!I", 0)            # TTL/HL fields unused
        return struct.pack("!BBH", 6, 0xC0, len(body) // 4) + body

    @classmethod
    def unpack(cls, blk: bytes) -> "XrStatSummary":
        ssrc, b, e, lost, dup, mnj, mxj, mej, dvj = \
            struct.unpack_from("!IHHIIIIII", blk, 4)
        return cls(ssrc, b, e, lost, dup, mnj, mxj, mej, dvj)


def pack_xr(sender_ssrc: int, blocks: List[bytes]) -> bytes:
    body = struct.pack("!I", sender_ssrc) + b"".join(blocks)
    hdr = struct.pack("!BBH", 0x80, RTCP_XR, len(body) // 4)
    return hdr + body


def parse_compound(data: bytes):
    """Yield parsed RTCP messages from a compound packet."""
    out = []
    off = 0
    while off + 4 <= len(data):
        b0, pt, length = struct.unpack_from("!BBH", data, off)
        size = 4 * (length + 1)
        chunk = data[off + 4: off + size]
        count = b0 & 0x1F
        if pt == RTCP_SR and len(chunk) >= 24:
            ssrc, ns, nf, ts, pc, oc = struct.unpack_from("!IIIIII", chunk)
            reports = [ReportBlock.unpack(chunk[24 + 24 * i:])
                       for i in range(count)
                       if len(chunk) >= 24 + 24 * (i + 1)]
            out.append(SenderReport(ssrc, ns, nf, ts, pc, oc, reports))
        elif pt == RTCP_RR and len(chunk) >= 4:
            ssrc = struct.unpack_from("!I", chunk)[0]
            reports = [ReportBlock.unpack(chunk[4 + 24 * i:])
                       for i in range(count)
                       if len(chunk) >= 4 + 24 * (i + 1)]
            out.append(ReceiverReport(ssrc, reports))
        elif pt in (RTCP_RTPFB, RTCP_PSFB) and len(chunk) >= 8:
            snd, med = struct.unpack_from("!II", chunk)
            fci = chunk[8:]
            fmt = count
            if pt == RTCP_PSFB and fmt == FMT_REMB \
                    and fci[:4] == b"REMB" and len(fci) >= 8:
                _, b1, lo = struct.unpack_from("!BBH", fci, 4)
                exp = b1 >> 2
                mant = ((b1 & 0x3) << 16) | lo
                out.append(Feedback("remb", snd, med, mant << exp))
            elif pt == RTCP_PSFB and fmt == FMT_PLI:
                out.append(Feedback("pli", snd, med))
            elif pt == RTCP_PSFB and fmt == FMT_FIR:
                out.append(Feedback("fir", snd, med, fci[4] if len(fci) > 4 else 0))
            elif pt == RTCP_PSFB and fmt == FMT_SLI and len(fci) >= 4:
                out.append(Feedback("sli", snd, med,
                                    struct.unpack_from("!I", fci)[0]))
            elif pt == RTCP_PSFB and fmt == FMT_RPSI and len(fci) >= 2:
                pb, ptype = fci[0], fci[1] & 0x7F
                bits = fci[2:len(fci) - pb // 8] if pb else fci[2:]
                out.append(Feedback("rpsi", snd, med, ptype, bytes(bits)))
            elif pt == RTCP_RTPFB and fmt == FMT_TMMBR and len(fci) >= 8:
                _, packed = struct.unpack_from("!II", fci)
                exp = packed >> 26
                mant = (packed >> 9) & 0x1FFFF
                out.append(Feedback("tmmbr", snd, med, mant << exp))
            elif pt == RTCP_RTPFB and fmt == FMT_NACK and len(fci) >= 4:
                seq, _ = struct.unpack_from("!HH", fci)
                out.append(Feedback("nack", snd, med, seq))
        elif pt == RTCP_SDES and len(chunk) >= 4:
            ssrc = struct.unpack_from("!I", chunk)[0]
            s = Sdes(ssrc)
            o = 4
            while o + 2 <= len(chunk) and chunk[o] != 0:
                item, ln = chunk[o], chunk[o + 1]
                val = chunk[o + 2: o + 2 + ln].decode(errors="replace")
                if item == SDES_CNAME:
                    s.cname = val
                elif item == SDES_TOOL:
                    s.tool = val
                o += 2 + ln
            out.append(s)
        elif pt == RTCP_XR and len(chunk) >= 4:
            o = 4
            while o + 4 <= len(chunk):
                bt, _, bl = struct.unpack_from("!BBH", chunk, o)
                blen = 4 * (bl + 1)
                if bt == XR_BLOCK_VOIP_METRICS and o + blen <= len(chunk):
                    out.append(XrVoipMetrics.unpack(chunk[o:o + blen]))
                elif bt == XR_BLOCK_RCVR_RTT and o + blen <= len(chunk):
                    out.append(XrReceiverReferenceTime.unpack(
                        chunk[o:o + blen]))
                elif bt == 5 and o + blen <= len(chunk):
                    out.append(XrDlrr.unpack(chunk[o:o + blen]))
                elif bt == 6 and o + blen <= len(chunk):
                    out.append(XrStatSummary.unpack(chunk[o:o + blen]))
                o += blen
        off += size
    return out


class RtcpSession:
    """Periodic SR/RR emission + inbound processing for one leg.

    cf. oRTP's RTCP scheduler; default 5 s interval (audio) like the
    reference; stats feed MSQosAnalyzer-equivalent logic.
    """

    def __init__(self, rtp_session, interval_s: float = 5.0):
        self.rtp = rtp_session
        self.interval_s = interval_s
        # RFC 3550 §6.1: every compound packet carries an SDES with CNAME
        self.cname = f"{rtp_session.ssrc:08x}@mediastreamer2_tpu"
        self.tool = "mediastreamer2_tpu"
        self._next_emit = time.monotonic() + interval_s
        self.last_rtt_ms: Optional[float] = None
        self.remote_reports: List[ReportBlock] = []
        self.feedback_in: List[Feedback] = []
        self._last_sr_time = 0.0
        self._last_sr_lsr = 0

    def maybe_emit(self, transport) -> Optional[bytes]:
        now = time.monotonic()
        if now < self._next_emit:
            return None
        self._next_emit = now + self.interval_s
        ns, nf = ntp_now()
        jb = self.rtp.jitter_buffer
        rb = []
        if self.rtp.recv_ssrc is not None and jb is not None:
            expected = self.rtp.stats.recv_packets + jb.lost
            frac = min(255, int(256 * jb.lost / max(expected, 1)))
            dlsr = 0
            if self._last_sr_time:
                dlsr = int((time.monotonic() - self._last_sr_time) * 65536)
            rb = [ReportBlock(self.rtp.recv_ssrc, frac, jb.lost, 0,
                              int(getattr(self.rtp, "jitter_units", 0.0)),
                              self._last_sr_lsr, dlsr)]
        sr = SenderReport(self.rtp.ssrc, ns, nf, self.rtp.ts,
                          self.rtp.stats.sent_packets,
                          self.rtp.stats.sent_bytes, rb)
        self._own_sr_ntp_mid = ((ns & 0xFFFF) << 16) | (nf >> 16)
        self._own_sr_wall = now
        pkt = sr.pack() + Sdes(self.rtp.ssrc, cname=self.cname,
                               tool=self.tool).pack()
        if self.rtp._cleartext_blocked():
            # encryption-mandatory leg without SRTCP yet: no plaintext RTCP
            self.rtp.mandatory_dropped += 1
            return pkt
        transport.send(pkt)
        return pkt

    def set_rtcp_information(self, cname: str, tool: str = ""):
        """media_stream_set_rtcp_information parity (mediastream.c)."""
        self.cname = cname
        if tool:
            self.tool = tool

    def send_bye(self, transport, reason: str = ""):
        """RTCP BYE on teardown (RFC 3550 §6.6; the reference emits BYE
        from rtp_session uninit)."""
        r = reason.encode()[:255]
        body = struct.pack("!I", self.rtp.ssrc)
        if r:
            body += bytes([len(r)]) + r
            body += b"\x00" * ((-len(r) - 1) % 4)
        hdr = struct.pack("!BBH", 0x80 | 1, RTCP_BYE, len(body) // 4)
        if not self.rtp._cleartext_blocked():
            transport.send(hdr + body)

    def process(self, data: bytes):
        self.bye_received = getattr(self, "bye_received", False)
        # BYE appears in compound packets; scan raw headers for PT 203
        off = 0
        while off + 4 <= len(data):
            b0, pt, length = struct.unpack_from("!BBH", data, off)
            if pt == RTCP_BYE:
                self.bye_received = True
            off += 4 * (length + 1)
        for msg in parse_compound(data):
            if isinstance(msg, SenderReport):
                self._last_sr_lsr = ((msg.ntp_sec & 0xFFFF) << 16) | \
                                    (msg.ntp_frac >> 16)
                self._last_sr_time = time.monotonic()
                self._rtt_from_reports(msg.reports)
                self.remote_reports.extend(msg.reports)
            elif isinstance(msg, ReceiverReport):
                self._rtt_from_reports(msg.reports)
                self.remote_reports.extend(msg.reports)
            elif isinstance(msg, Feedback):
                self.feedback_in.append(msg)

    def _rtt_from_reports(self, reports):
        """RFC 3550 §6.4.1 RTT: now - LSR - DLSR, when LSR matches our SR."""
        own = getattr(self, "_own_sr_ntp_mid", None)
        if own is None:
            return
        for rb in reports:
            if rb.lsr == own and rb.lsr != 0:
                elapsed = time.monotonic() - self._own_sr_wall
                self.last_rtt_ms = max(
                    0.0, (elapsed - rb.dlsr / 65536.0) * 1000.0)
