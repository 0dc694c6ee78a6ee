"""RTP/JPEG payload format (RFC 2435) — the MJPEG wire transport (a copy of
``mediastreamer2_tpu/net/jpeg_rtp.py``: plain Python).

Reference: the legacy ffmpeg MJPEG codec (videoenc.c family) rides the
RTP profile's static PT 26 JPEG payload. The format strips the JFIF
wrapper: each packet carries an 8-octet main header (fragment offset,
type, Q, width/8, height/8); with Q >= 128 the FIRST fragment carries the
quantization tables explicitly, and the receiver reconstructs a baseline
JFIF stream using the standard Huffman tables (RFC 2435 Appendix A/B —
the tables below are those spec constants).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

# --- standard JPEG Huffman tables (RFC 2435 Appendix B / ISO 10918-1) ----
LUM_DC_CODELENS = bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0])
LUM_DC_SYMBOLS = bytes(range(12))
LUM_AC_CODELENS = bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D])
LUM_AC_SYMBOLS = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12,
    0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16,
    0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98,
    0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4,
    0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA,
    0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA])
CHM_DC_CODELENS = bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0])
CHM_DC_SYMBOLS = bytes(range(12))
CHM_AC_CODELENS = bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77])
CHM_AC_SYMBOLS = bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21,
    0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34,
    0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2,
    0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9,
    0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA])


def _parse_jfif(jpeg: bytes):
    """Extract (type, width, height, quant_tables{id: 64B}, scan_data, dri)
    from a baseline JFIF stream."""
    assert jpeg[:2] == b"\xFF\xD8", "not a JPEG (no SOI)"
    pos = 2
    qtables: Dict[int, bytes] = {}
    width = height = 0
    jtype = None
    dri = 0
    while pos + 4 <= len(jpeg):
        if jpeg[pos] != 0xFF:
            pos += 1
            continue
        marker = jpeg[pos + 1]
        if marker == 0xD9:                       # EOI
            break
        seg_len = struct.unpack("!H", jpeg[pos + 2:pos + 4])[0]
        body = jpeg[pos + 4:pos + 2 + seg_len]
        if marker == 0xDB:                       # DQT
            i = 0
            while i < len(body):
                prec_id = body[i]
                tid, prec = prec_id & 0x0F, prec_id >> 4
                n = 64 * (2 if prec else 1)
                qtables[tid] = body[i + 1:i + 1 + n]
                i += 1 + n
        elif marker == 0xC0:                     # SOF0 baseline
            height, width = struct.unpack("!HH", body[1:5])
            ncomp = body[5]
            assert ncomp == 3, "JPEG/RTP needs YUV"
            # component 1 sampling: 0x22 = 4:2:0 (type 1), 0x21 = 4:2:2
            samp = body[7]
            jtype = 1 if samp == 0x22 else 0
        elif marker == 0xC4:                     # DHT: rebuilt standard
            pass
        elif marker == 0xDD:                     # DRI
            dri = struct.unpack("!H", body[:2])[0]
        elif marker == 0xDA:                     # SOS: scan follows
            scan_start = pos + 2 + seg_len
            end = jpeg.rfind(b"\xFF\xD9")
            scan = jpeg[scan_start:end if end > 0 else len(jpeg)]
            if jtype is None:
                raise ValueError("no SOF0 before SOS (not baseline)")
            if dri:
                jtype += 64
            return jtype, width, height, qtables, scan, dri
        pos += 2 + seg_len
    raise ValueError("no scan data found")


def jpeg_packetize(jpeg: bytes, mtu: int = 1400) -> List[bytes]:
    """One JFIF image -> RFC 2435 payloads (Q=255: explicit quant tables
    on the first fragment)."""
    jtype, w, h, qtables, scan, dri = _parse_jfif(jpeg)
    lqt = qtables.get(0, bytes(64))
    cqt = qtables.get(1, lqt)
    payloads: List[bytes] = []
    off = 0
    while off < len(scan) or not payloads:
        hdr = struct.pack("!BBBBBB", 0, (off >> 16) & 0xFF,
                          (off >> 8) & 0xFF, off & 0xFF,
                          jtype, 255) + bytes([w // 8, h // 8])
        extra = b""
        if (jtype & 0x3F) in (0, 1) and off == 0:
            # quantization table header (MBZ, precision=0, length)
            extra = struct.pack("!BBH", 0, 0, len(lqt) + len(cqt)) \
                + lqt + cqt
        if dri and off == 0:
            # restart marker header precedes the quant header (type>=64)
            extra = struct.pack("!HH", dri, 0xFFFF) + extra
        room = mtu - len(hdr) - len(extra)
        chunk = scan[off:off + room]
        payloads.append(hdr + extra + chunk)
        off += len(chunk)
    return payloads


def _build_jfif(jtype: int, w: int, h: int, lqt: bytes, cqt: bytes,
                scan: bytes, dri: int = 0) -> bytes:
    def seg(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack("!H", len(body) + 2) + body

    def dht(cls_id: int, codelens: bytes, symbols: bytes) -> bytes:
        return seg(0xC4, bytes([cls_id]) + codelens + symbols)

    samp = 0x22 if (jtype & 0x3F) == 1 else 0x21
    sof = bytes([8]) + struct.pack("!HH", h, w) + bytes([
        3, 1, samp, 0, 2, 0x11, 1, 3, 0x11, 1])
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    out = (b"\xFF\xD8"
           + seg(0xDB, bytes([0x00]) + lqt)
           + seg(0xDB, bytes([0x01]) + cqt))
    if dri:
        out += seg(0xDD, struct.pack("!H", dri))
    out += (seg(0xC0, sof)
            + dht(0x00, LUM_DC_CODELENS, LUM_DC_SYMBOLS)
            + dht(0x10, LUM_AC_CODELENS, LUM_AC_SYMBOLS)
            + dht(0x01, CHM_DC_CODELENS, CHM_DC_SYMBOLS)
            + dht(0x11, CHM_AC_CODELENS, CHM_AC_SYMBOLS)
            + seg(0xDA, sos) + scan + b"\xFF\xD9")
    return out


class JpegDepacketizer:
    """RFC 2435 payloads -> JFIF images (marker bit closes the frame)."""

    def __init__(self):
        self._frags: List[Tuple[int, bytes]] = []
        self._meta = None                        # (type, w, h, lqt, cqt, dri)
        self.completed: List[bytes] = []
        self.errors = 0

    def push(self, payload: bytes, marker: bool):
        if len(payload) < 8:
            self.errors += 1
            return
        off = (payload[1] << 16) | (payload[2] << 8) | payload[3]
        jtype, q, w8, h8 = payload[4], payload[5], payload[6], payload[7]
        pos = 8
        dri = 0
        if jtype >= 64:
            if len(payload) < pos + 4:
                self.errors += 1
                return
            dri = struct.unpack("!H", payload[pos:pos + 2])[0]
            pos += 4
        if off == 0:
            lqt = cqt = None
            if q >= 128:                         # explicit tables
                if len(payload) < pos + 4:
                    self.errors += 1
                    return
                _, _, qlen = struct.unpack("!BBH", payload[pos:pos + 4])
                pos += 4
                tables = payload[pos:pos + qlen]
                pos += qlen
                lqt = tables[:64]
                cqt = tables[64:128] if qlen >= 128 else lqt
            self._meta = (jtype, w8 * 8, h8 * 8, lqt, cqt, dri)
            self._frags = []
        self._frags.append((off, payload[pos:]))
        if marker:
            if self._meta is None:
                self.errors += 1
                return
            jt, w, h, lqt, cqt, dri2 = self._meta
            self._frags.sort()
            scan = b"".join(d for _, d in self._frags)
            self.completed.append(_build_jfif(jt, w, h, lqt or bytes(64),
                                              cqt or lqt or bytes(64),
                                              scan, dri2))
            self._frags = []
            self._meta = None

    def pop(self) -> Optional[bytes]:
        return self.completed.pop(0) if self.completed else None
