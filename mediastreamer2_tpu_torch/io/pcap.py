"""pcap read/write + RTP replay — deterministic network-pathology tests
(a copy of ``mediastreamer2_tpu/io/pcap.py`` on the port's ``RtpPacket``;
``write_pcap`` packs the two addresses once a file, not once a packet,
and writes the same bytes).

Reference: src/utils/pcap_sender.c replays pcap files as RTP for tests, and
the jitter-buffer tester feeds pcapng scenario captures
(tester/scenarios/rtp-534late-24loss-7000total.pcapng) through it
(tester/mediastreamer2_jitterbuffer_tester.c:86-122).

Scope: classic pcap (magic 0xa1b2c3d4, usec or nsec), Ethernet/Linux-SLL/
raw-IP link types, UDP extraction; a writer so tests can fabricate
pathological captures; and PcapRtpPlayer which replays the capture's RTP
packets into a jitter buffer with original timing (optionally time-scaled).
"""
from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional

from mediastreamer2_tpu_torch.net.rtp import RtpPacket

MAGIC_USEC = 0xA1B2C3D4
MAGIC_NSEC = 0xA1B23C4D
LINKTYPE_NULL = 0          # BSD/macOS loopback: 4-byte AF family header
LINKTYPE_ETHERNET = 1
LINKTYPE_RAW = 101
LINKTYPE_LINUX_SLL = 113


@dataclasses.dataclass
class CapturedPacket:
    ts: float                   # seconds
    udp_payload: bytes
    src_port: int = 0
    dst_port: int = 0


def _parse_udp(link_type: int, frame: bytes) -> Optional[CapturedPacket]:
    if link_type == LINKTYPE_ETHERNET:
        if len(frame) < 14 or frame[12:14] not in (b"\x08\x00", b"\x86\xdd"):
            return None
        ip = frame[14:]
    elif link_type == LINKTYPE_LINUX_SLL:
        if len(frame) < 16 or frame[14:16] != b"\x08\x00":
            return None
        ip = frame[16:]
    elif link_type == LINKTYPE_NULL:
        if len(frame) < 4:
            return None
        fam = int.from_bytes(frame[:4], "little")
        if fam not in (2, 0x02000000):     # AF_INET either byte order
            return None
        ip = frame[4:]
    else:                       # raw IP
        ip = frame
    if len(ip) >= 48 and ip[0] >> 4 == 6 and ip[6] == 17:   # IPv6 + UDP
        udp = ip[40:]
    elif len(ip) >= 20 and ip[0] >> 4 == 4 and ip[9] == 17:
        ihl = (ip[0] & 0xF) * 4
        udp = ip[ihl:]
    else:
        return None
    if len(udp) < 8:
        return None
    sport, dport, ulen, _ = struct.unpack("!HHHH", udp[:8])
    return CapturedPacket(0.0, udp[8:ulen], sport, dport)


def read_pcap(path: str) -> List[CapturedPacket]:
    out: List[CapturedPacket] = []
    with open(path, "rb") as f:
        hdr = f.read(24)
        if len(hdr) < 24:
            raise ValueError("truncated pcap header")
        magic = struct.unpack("<I", hdr[:4])[0]
        if magic == MAGIC_USEC:
            div, endian = 1e6, "<"
        elif magic == MAGIC_NSEC:
            div, endian = 1e9, "<"
        elif magic in (0xD4C3B2A1, 0x4D3CB2A1):
            div = 1e6 if magic == 0xD4C3B2A1 else 1e9
            endian = ">"
        else:
            raise ValueError("not a classic pcap (pcapng unsupported here)")
        link_type = struct.unpack(endian + "I", hdr[20:24])[0]
        while True:
            ph = f.read(16)
            if len(ph) < 16:
                break
            sec, frac, caplen, _wirelen = struct.unpack(endian + "IIII", ph)
            frame = f.read(caplen)
            pkt = _parse_udp(link_type, frame)
            if pkt is not None:
                pkt.ts = sec + frac / div
                out.append(pkt)
    return out


def read_pcapng(path: str) -> List[CapturedPacket]:
    """pcapng (the reference's tester/scenarios/*.pcapng files): SHB + IDB +
    EPB block walk, per-interface link type and timestamp resolution."""
    out: List[CapturedPacket] = []
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    endian = "<"
    ifaces: List[tuple] = []            # (link_type, ticks_per_second)
    while off + 12 <= len(data):
        btype = struct.unpack_from(endian + "I", data, off)[0]
        if btype == 0x0A0D0D0A:         # Section Header Block
            bom = struct.unpack_from("<I", data, off + 8)[0]
            endian = "<" if bom == 0x1A2B3C4D else ">"
            ifaces = []
            blen = struct.unpack_from(endian + "I", data, off + 4)[0]
        else:
            blen = struct.unpack_from(endian + "I", data, off + 4)[0]
            if blen < 12 or off + blen > len(data):
                break
            body = data[off + 8: off + blen - 4]
            if btype == 1:              # Interface Description Block
                link_type = struct.unpack_from(endian + "H", body, 0)[0]
                tps = 1_000_000         # default if_tsresol = 6 (microsec)
                o = 8
                while o + 4 <= len(body):
                    code, olen = struct.unpack_from(endian + "HH", body, o)
                    if code == 0:
                        break
                    if code == 9 and olen >= 1:        # if_tsresol
                        v = body[o + 4]
                        tps = (1 << (v & 0x7F)) if v & 0x80 else 10 ** v
                    o += 4 + ((olen + 3) & ~3)
                ifaces.append((link_type, tps))
            elif btype == 6 and len(body) >= 20:       # Enhanced Packet Block
                iface, ts_hi, ts_lo, caplen, _wl = struct.unpack_from(
                    endian + "IIIII", body, 0)
                frame = body[20:20 + caplen]
                link_type, tps = ifaces[iface] if iface < len(ifaces) \
                    else (LINKTYPE_ETHERNET, 1_000_000)
                pkt = _parse_udp(link_type, frame)
                if pkt is not None:
                    pkt.ts = ((ts_hi << 32) | ts_lo) / tps
                    out.append(pkt)
        off += blen
    return out


def read_capture(path: str) -> List[CapturedPacket]:
    """Sniff classic pcap vs pcapng and parse accordingly."""
    with open(path, "rb") as f:
        magic = f.read(4)
    if magic == b"\x0a\x0d\x0d\x0a":
        return read_pcapng(path)
    return read_pcap(path)


def write_pcap(path: str, packets: List[CapturedPacket],
               src=("10.0.0.1", 5004), dst=("10.0.0.2", 5004)):
    """Write UDP packets as raw-IP classic pcap (tests fabricate scenarios)."""
    def ip4(s):
        return bytes(int(x) for x in s.split("."))
    src_ip, dst_ip = ip4(src[0]), ip4(dst[0])      # once, not per packet
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", MAGIC_USEC, 2, 4, 0, 0, 65535,
                            LINKTYPE_RAW))
        for p in packets:
            sport = p.src_port or src[1]
            dport = p.dst_port or dst[1]
            udp = struct.pack("!HHHH", sport, dport, 8 + len(p.udp_payload), 0
                              ) + p.udp_payload
            total = 20 + len(udp)
            ip = struct.pack("!BBHHHBBH4s4s", 0x45, 0, total, 0, 0, 64, 17, 0,
                             src_ip, dst_ip) + udp
            sec = int(p.ts)
            usec = int((p.ts - sec) * 1e6)
            f.write(struct.pack("<IIII", sec, usec, len(ip), len(ip)))
            f.write(ip)


class PcapRtpPlayer:
    """Replay a capture's RTP stream with original timing
    (cf. pcap_sender.c / MSPCAPFilePlayer)."""

    def __init__(self, path: str, payload_type: Optional[int] = None,
                 time_scale: float = 1.0):
        self.packets = []
        for cp in read_capture(path):
            try:
                pkt = RtpPacket.unpack(cp.udp_payload)
            except ValueError:
                continue
            if payload_type is not None and pkt.payload_type != payload_type:
                continue
            self.packets.append((cp.ts, pkt))
        if self.packets:
            t0 = self.packets[0][0]
            self.packets = [((t - t0) / time_scale, p) for t, p in self.packets]
        self._idx = 0

    def due(self, now_s: float) -> List[RtpPacket]:
        """Packets whose (relative) capture time has arrived."""
        out = []
        while self._idx < len(self.packets) and self.packets[self._idx][0] <= now_s:
            out.append(self.packets[self._idx][1])
            self._idx += 1
        return out

    @property
    def finished(self) -> bool:
        return self._idx >= len(self.packets)
