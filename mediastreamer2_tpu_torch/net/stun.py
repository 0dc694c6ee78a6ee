"""STUN (RFC 5389) message codec + client helpers — host side (a copy of
``mediastreamer2_tpu/net/stun.py``: plain Python).

Reference: src/voip/stun.c (1,725 LoC message codec + auth).  Scope here:
binding request/response/indication, XOR-MAPPED-ADDRESS, USERNAME,
MESSAGE-INTEGRITY (HMAC-SHA1), FINGERPRINT (CRC32), PRIORITY,
USE-CANDIDATE, ICE-CONTROLLED/CONTROLLING — everything ICE connectivity
checks need (net/ice.py) plus plain binding for server-reflexive discovery
and the RTP keepalives MSRtpSend emits.
"""
from __future__ import annotations

import hashlib
import hmac
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

MAGIC_COOKIE = 0x2112A442

BINDING_REQUEST = 0x0001
BINDING_RESPONSE = 0x0101
BINDING_ERROR = 0x0111
BINDING_INDICATION = 0x0011

ATTR_MAPPED_ADDRESS = 0x0001
ATTR_USERNAME = 0x0006
ATTR_MESSAGE_INTEGRITY = 0x0008
ATTR_ERROR_CODE = 0x0009
ATTR_XOR_MAPPED_ADDRESS = 0x0020
ATTR_PRIORITY = 0x0024
ATTR_USE_CANDIDATE = 0x0025
ATTR_FINGERPRINT = 0x8028
ATTR_ICE_CONTROLLED = 0x8029
ATTR_ICE_CONTROLLING = 0x802A
ATTR_SOFTWARE = 0x8022


class StunMessage:
    def __init__(self, msg_type: int, transaction_id: Optional[bytes] = None):
        self.msg_type = msg_type
        self.transaction_id = transaction_id or os.urandom(12)
        self.attrs: Dict[int, bytes] = {}

    # -- attribute helpers -----------------------------------------------
    def set_xor_mapped_address(self, host: str, port: int):
        ip = bytes(int(x) for x in host.split("."))
        xport = port ^ (MAGIC_COOKIE >> 16)
        xip = bytes(b ^ m for b, m in zip(ip, struct.pack("!I", MAGIC_COOKIE)))
        self.attrs[ATTR_XOR_MAPPED_ADDRESS] = struct.pack("!BBH", 0, 1, xport) + xip

    def get_xor_mapped_address(self) -> Optional[Tuple[str, int]]:
        v = self.attrs.get(ATTR_XOR_MAPPED_ADDRESS)
        if not v or v[1] != 1:
            return None
        xport = struct.unpack("!H", v[2:4])[0] ^ (MAGIC_COOKIE >> 16)
        ip = bytes(b ^ m for b, m in zip(v[4:8], struct.pack("!I", MAGIC_COOKIE)))
        return ".".join(str(b) for b in ip), xport

    def set_username(self, u: str):
        self.attrs[ATTR_USERNAME] = u.encode()

    def set_priority(self, p: int):
        self.attrs[ATTR_PRIORITY] = struct.pack("!I", p)

    def set_use_candidate(self):
        self.attrs[ATTR_USE_CANDIDATE] = b""

    def set_role(self, controlling: bool, tiebreaker: int):
        a = ATTR_ICE_CONTROLLING if controlling else ATTR_ICE_CONTROLLED
        self.attrs[a] = struct.pack("!Q", tiebreaker)

    def set_error(self, code: int, reason: str = ""):
        self.attrs[ATTR_ERROR_CODE] = struct.pack(
            "!HBB", 0, code // 100, code % 100) + reason.encode()

    def get_error(self) -> Optional[int]:
        v = self.attrs.get(ATTR_ERROR_CODE)
        if not v:
            return None
        return v[2] * 100 + v[3]

    # -- wire format -------------------------------------------------------
    def _encode_attrs(self, attrs: Dict[int, bytes]) -> bytes:
        out = b""
        for t, v in attrs.items():
            out += struct.pack("!HH", t, len(v)) + v
            if len(v) % 4:
                out += b"\x00" * (4 - len(v) % 4)
        return out

    def pack(self, password: Optional[str] = None,
             fingerprint: bool = True) -> bytes:
        attrs = dict(self.attrs)
        attrs.pop(ATTR_MESSAGE_INTEGRITY, None)
        attrs.pop(ATTR_FINGERPRINT, None)
        body = self._encode_attrs(attrs)
        if password is not None:
            # length includes the 24-byte MI attribute; key may be a raw
            # bytes key (TURN long-term credential md5) or a password string
            key = password if isinstance(password, bytes) else password.encode()
            hdr = struct.pack("!HHI", self.msg_type, len(body) + 24,
                              MAGIC_COOKIE) + self.transaction_id
            mac = hmac.new(key, hdr + body, hashlib.sha1).digest()
            body += struct.pack("!HH", ATTR_MESSAGE_INTEGRITY, 20) + mac
        if fingerprint:
            hdr = struct.pack("!HHI", self.msg_type, len(body) + 8,
                              MAGIC_COOKIE) + self.transaction_id
            crc = (zlib.crc32(hdr + body) ^ 0x5354554E) & 0xFFFFFFFF
            body += struct.pack("!HHI", ATTR_FINGERPRINT, 4, crc)
        hdr = struct.pack("!HHI", self.msg_type, len(body),
                          MAGIC_COOKIE) + self.transaction_id
        return hdr + body

    @classmethod
    def unpack(cls, data: bytes) -> "StunMessage":
        if len(data) < 20:
            raise ValueError("short STUN")
        msg_type, length, cookie = struct.unpack_from("!HHI", data)
        if cookie != MAGIC_COOKIE or msg_type & 0xC000:
            raise ValueError("not STUN")
        m = cls(msg_type, data[8:20])
        off = 20
        while off + 4 <= 20 + length and off + 4 <= len(data):
            t, l = struct.unpack_from("!HH", data, off)
            m.attrs[t] = data[off + 4: off + 4 + l]
            off += 4 + l + ((4 - l % 4) % 4)
        return m

    def check_integrity(self, password: str) -> bool:
        mi = self.attrs.get(ATTR_MESSAGE_INTEGRITY)
        if mi is None:
            return False
        clone = StunMessage(self.msg_type, self.transaction_id)
        clone.attrs = {t: v for t, v in self.attrs.items()
                       if t not in (ATTR_MESSAGE_INTEGRITY, ATTR_FINGERPRINT)}
        packed = clone.pack(password=password, fingerprint=False)
        return hmac.compare_digest(packed[-20:], mi)


def is_stun(data: bytes) -> bool:
    """Demultiplex STUN from RTP on the same socket (RFC 5764 §5.1.2)."""
    return (len(data) >= 20 and data[0] < 4
            and struct.unpack_from("!I", data, 4)[0] == MAGIC_COOKIE)


def make_binding_request(username: str = "", password: Optional[str] = None,
                         priority: int = 0, controlling: Optional[bool] = None,
                         tiebreaker: int = 0, use_candidate: bool = False) -> StunMessage:
    m = StunMessage(BINDING_REQUEST)
    if username:
        m.set_username(username)
    if priority:
        m.set_priority(priority)
    if controlling is not None:
        m.set_role(controlling, tiebreaker)
    if use_candidate:
        m.set_use_candidate()
    return m


def make_binding_response(req: StunMessage, host: str, port: int) -> StunMessage:
    m = StunMessage(BINDING_RESPONSE, req.transaction_id)
    m.set_xor_mapped_address(host, port)
    return m
